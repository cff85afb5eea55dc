"""Replay buffers (parity: reference rllib/utils/replay_buffers/ —
replay_buffer.py, prioritized_replay_buffer.py). Port of
ray_tpu/rllib/replay.py, a copy (numpy only).

`ReplayBuffer` (uniform) lives in dqn.py as in the reference and is
re-exported here; `PrioritizedReplayBuffer` adds proportional
prioritization (Schaul et al. 2016) with importance-sampling weights.
Both keep their seeded numpy generator, so they draw the reference's
indices and weights.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.dqn import ReplayBuffer

__all__ = ["ReplayBuffer", "PrioritizedReplayBuffer"]


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay: P(i) ∝ p_i^alpha, with IS weights
    w_i = (N·P(i))^-beta / max w. New samples enter at max priority so
    every transition is trained on at least once."""

    def __init__(self, capacity: int, obs_size: int, seed: int = 0,
                 alpha: float = 0.6, beta: float = 0.4,
                 action_shape: tuple = (), action_dtype=np.int32):
        super().__init__(capacity, obs_size, seed, action_shape, action_dtype)
        self.alpha = alpha
        self.beta = beta
        self.priorities = np.zeros(capacity, np.float32)
        self.max_priority = 1.0

    def add_batch(self, batch: dict) -> None:
        n = len(batch["obs"])
        idx = (self.pos + np.arange(n)) % self.capacity
        super().add_batch(batch)
        self.priorities[idx] = self.max_priority

    def sample(self, batch_size: int) -> dict:
        p = self.priorities[: self.size] ** self.alpha
        probs = p / p.sum()
        idx = self.rng.choice(self.size, batch_size, p=probs)
        weights = (self.size * probs[idx]) ** (-self.beta)
        weights = (weights / weights.max()).astype(np.float32)
        return {"obs": self.obs[idx], "next_obs": self.next_obs[idx],
                "actions": self.actions[idx], "rewards": self.rewards[idx],
                "dones": self.dones[idx], "weights": weights,
                "indices": idx.astype(np.int64)}

    def update_priorities(self, indices: np.ndarray,
                          td_errors: np.ndarray) -> None:
        prios = np.abs(np.asarray(td_errors, np.float32)) + 1e-6
        self.priorities[np.asarray(indices, np.int64)] = prios
        self.max_priority = max(self.max_priority, float(prios.max()))
