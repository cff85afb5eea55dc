"""A3C: asynchronous advantage actor-critic. Port of ray_tpu/rllib/a3c.py.

Parity: reference rllib/algorithms/a3c/ — the asynchronous ancestor of
A2C: each rollout worker samples with (possibly stale) weights and the
learner applies a gradient step PER ARRIVING batch instead of waiting
for the whole worker set. Here that is a wait-any loop over sample
futures: workers never block on each other or on learning, matching
the hogwild-style staleness tolerance of the original.

Reuses A2C's loss/update (init in A2CConfig terms); only the
synchronization topology differs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.a2c import _BATCH_KEYS, A2C, A2CConfig


@dataclass
class A3CConfig(A2CConfig):
    """Fluent config (parity: rllib A3CConfig)."""

    num_rollout_workers: int = 2
    # how many per-batch async updates make one train() iteration
    batches_per_iter: int = 4

    def build(self, device=None) -> "A3C":  # type: ignore[override]
        return A3C(self, device=device)


class A3C(A2C):
    def __init__(self, config: A3CConfig, device=None):
        super().__init__(config, device=device)
        self._inflight: dict = {}

    def _launch(self, i: int):
        fut = self.workers[i].sample.remote(
            self.params, self.config.rollout_fragment_length)
        self._inflight[fut] = i

    def train(self) -> dict:
        cfg: A3CConfig = self.config  # type: ignore[assignment]
        t0 = time.time()
        for i in range(len(self.workers)):
            if i not in self._inflight.values():
                self._launch(i)

        episode_returns: list = []
        losses: list = []
        n_steps = 0
        for _ in range(cfg.batches_per_iter):
            ready, _ = ray_tpu_torch.wait(list(self._inflight),
                                          num_returns=1, timeout=600)
            fut = ready[0]
            i = self._inflight.pop(fut)
            batch = ray_tpu_torch.get(fut, timeout=60)
            episode_returns.extend(batch.pop("episode_returns", []))
            # One async gradient step on this worker's (stale-weight)
            # batch, then hand the worker the NEW weights.
            loss, _aux = self.learner.update(
                {k: batch[k] for k in _BATCH_KEYS})
            losses.append(float(loss))
            n_steps += len(batch["obs"])
            self._launch(i)
        self.total_steps += n_steps
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(episode_returns))
            if episode_returns else 0.0,
            "episodes_this_iter": len(episode_returns),
            "timesteps_this_iter": n_steps,
            "timesteps_total": self.total_steps,
            "mean_loss": float(np.mean(losses)) if losses else 0.0,
            "iter_time_s": round(time.time() - t0, 3),
        }
