"""EnvRunner: vectorized environment stepping for rollout workers. Port of
ray_tpu/rllib/env_runner.py, a copy (numpy only).

Parity: reference rllib/env/env_runner.py + vector envs — one runner
owns N env copies and steps them with BATCHED policy forwards, so the
per-step cost is one matrix multiply over N observations instead of N
python-loop forwards. Episode accounting (returns, resets) is handled
per sub-env; connector pipelines apply per sub-env so stateful
connectors (frame stacks) stay episode-scoped.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from ray_tpu_torch.rllib.connectors import ConnectorPipeline
from ray_tpu_torch.rllib.env import make_env


class EnvRunner:
    def __init__(self, env_spec, num_envs: int = 1, *, seed: int = 0,
                 obs_connectors: Callable[[], ConnectorPipeline] | None = None,
                 act_connectors: Callable[[], ConnectorPipeline] | None = None):
        self.envs = [make_env(env_spec) for _ in range(num_envs)]
        self.num_envs = num_envs
        self._obs_pipes = [obs_connectors() if obs_connectors else
                           ConnectorPipeline() for _ in range(num_envs)]
        self._act_pipes = [act_connectors() if act_connectors else
                           ConnectorPipeline() for _ in range(num_envs)]
        self._ep_ret = np.zeros(num_envs)
        self.episode_returns: list[float] = []
        # Connector-transformed observations are computed EXACTLY ONCE per
        # env transition (stateful connectors — frame stacks, running
        # normalizers — advance on every application, so a repeated getter
        # would silently corrupt their state).
        self._cur_obs = [self._obs_pipes[i](e.reset(seed=seed + i))
                         for i, e in enumerate(self.envs)]

    @property
    def observation_size(self) -> int:
        return self.envs[0].observation_size

    def observations(self) -> np.ndarray:
        """Current per-env observations (transformed at transition time;
        safe to call repeatedly)."""
        return np.stack(self._cur_obs)

    def step(self, actions: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Step every sub-env with its (connector-transformed) action.
        Returns (rewards, dones); finished sub-envs auto-reset with their
        connector state cleared, and their returns land in
        self.episode_returns."""
        rewards = np.zeros(self.num_envs, np.float32)
        dones = np.zeros(self.num_envs, np.float32)
        for i, env in enumerate(self.envs):
            act = self._act_pipes[i](actions[i])
            obs, rew, done, _info = env.step(act)
            rewards[i] = rew
            dones[i] = float(done)
            self._ep_ret[i] += rew
            if done:
                self.episode_returns.append(float(self._ep_ret[i]))
                self._ep_ret[i] = 0.0
                self._obs_pipes[i].reset()
                obs = env.reset()
            self._cur_obs[i] = self._obs_pipes[i](obs)
        return rewards, dones

    def drain_episode_returns(self) -> list[float]:
        out, self.episode_returns = self.episode_returns, []
        return out

    def sample_fragment(self, forward: Callable, sample_action: Callable,
                        num_steps: int) -> dict[str, Any]:
        """Collect num_steps per sub-env with batched forwards.

        forward(obs_batch) -> (logits_or_mu, values); sample_action(
        per-row forward outputs, row index) -> (action, logp). Returns
        stacked (num_steps * num_envs) arrays in sub-env-major order
        with per-row episode boundaries preserved via `dones`.
        """
        obs_b, act_b, logp_b, rew_b, val_b, done_b = [], [], [], [], [], []
        for _ in range(num_steps):
            obs = self.observations()
            logits, values = forward(obs)
            acts, logps = [], []
            for i in range(self.num_envs):
                a, lp = sample_action(logits[i], i)
                acts.append(a)
                logps.append(lp)
            actions = np.asarray(acts)
            rewards, dones = self.step(actions)
            obs_b.append(obs)
            act_b.append(actions)
            logp_b.append(np.asarray(logps, np.float32))
            rew_b.append(rewards)
            val_b.append(np.asarray(values, np.float32))
            done_b.append(dones)
        # (T, N, ...) -> sub-env-major (N*T, ...) so GAE can scan each
        # sub-env's fragment contiguously.
        def swap(x):
            a = np.asarray(x)
            return np.swapaxes(a, 0, 1).reshape((-1,) + a.shape[2:])

        return {"obs": swap(obs_b), "actions": swap(act_b),
                "logp": swap(logp_b), "rew": swap(rew_b),
                "val": swap(val_b), "done": swap(done_b),
                "episode_returns": self.drain_episode_returns(),
                "num_envs": self.num_envs, "steps_per_env": num_steps}
