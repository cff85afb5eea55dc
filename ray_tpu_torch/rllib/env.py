"""Environment API + built-in CartPole. Port of ray_tpu/rllib/env.py, a
copy (numpy only).

Parity: reference rllib/env/env_runner.py's gym-style contract. A
dependency-free numpy CartPole (classic Barto-Sutton dynamics) stands in
for gym in tests and examples; any object with the same
reset()/step() surface works.
"""

from __future__ import annotations

import numpy as np


class Env:
    observation_size: int
    num_actions: int

    def reset(self, seed: int | None = None) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> tuple[np.ndarray, float, bool, dict]:
        raise NotImplementedError


class CartPole(Env):
    """Classic cart-pole balancing, matches gym's CartPole-v1 dynamics."""

    observation_size = 4
    num_actions = 2
    max_episode_steps = 500

    def __init__(self):
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.total_mass = self.masspole + self.masscart
        self.length = 0.5
        self.polemass_length = self.masspole * self.length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.x_threshold = 2.4
        self.state = None
        self.steps = 0
        self._rng = np.random.default_rng()

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform(-0.05, 0.05, size=4)
        self.steps = 0
        return self.state.astype(np.float32)

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self.state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        temp = (force + self.polemass_length * theta_dot ** 2 * sintheta
                ) / self.total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costheta ** 2
                           / self.total_mass))
        xacc = temp - self.polemass_length * thetaacc * costheta / self.total_mass
        x += self.tau * x_dot
        x_dot += self.tau * xacc
        theta += self.tau * theta_dot
        theta_dot += self.tau * thetaacc
        self.state = np.array([x, x_dot, theta, theta_dot])
        self.steps += 1
        terminal = bool(abs(x) > self.x_threshold
                        or abs(theta) > self.theta_threshold)
        truncated = self.steps >= self.max_episode_steps
        # info["truncated"]: the episode ended by TIME LIMIT, not failure —
        # off-policy targets should still bootstrap through it (gym's
        # TimeLimit.truncated convention).
        return (self.state.astype(np.float32), 1.0, terminal or truncated,
                {"truncated": truncated and not terminal})


class Pendulum(Env):
    """Classic torque-controlled pendulum swing-up, matches gym's
    Pendulum-v1 dynamics. Continuous action in [-2, 2]."""

    observation_size = 3
    num_actions = 0            # continuous
    action_size = 1
    action_low = -2.0
    action_high = 2.0
    max_episode_steps = 200

    def __init__(self):
        self.max_speed = 8.0
        self.dt = 0.05
        self.g = 10.0
        self.m = 1.0
        self.length = 1.0
        self.state = None
        self.steps = 0
        self._rng = np.random.default_rng()

    def _obs(self) -> np.ndarray:
        th, thdot = self.state
        return np.array([np.cos(th), np.sin(th), thdot], np.float32)

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.state = self._rng.uniform([-np.pi, -1.0], [np.pi, 1.0])
        self.steps = 0
        return self._obs()

    def step(self, action):
        th, thdot = self.state
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          self.action_low, self.action_high))
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        thdot = thdot + (3 * self.g / (2 * self.length) * np.sin(th)
                         + 3.0 / (self.m * self.length ** 2) * u) * self.dt
        thdot = np.clip(thdot, -self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        self.state = np.array([th, thdot])
        self.steps += 1
        done = self.steps >= self.max_episode_steps
        return self._obs(), -cost, done, {"truncated": done}


ENV_REGISTRY = {"CartPole-v1": CartPole, "CartPole": CartPole,
                "Pendulum-v1": Pendulum, "Pendulum": Pendulum}


def _register_late():  # populated after the classes below are defined
    ENV_REGISTRY.update({
        "VisualCatch-v0": VisualCatch, "VisualCatch": VisualCatch,
        "DualCartPole-v0": DualCartPole, "DualCartPole": DualCartPole,
    })


def make_env(env: str | type) -> Env:
    if isinstance(env, str):
        if env not in ENV_REGISTRY:
            raise ValueError(f"unknown env {env!r}; register it in "
                             "ray_tpu_torch.rllib.env.ENV_REGISTRY")
        return ENV_REGISTRY[env]()
    return env()


class VisualCatch(Env):
    """Atari-style PIXEL control task: a ball falls down a 42x42 frame,
    the agent slides a paddle to catch it (the classic minimal visual-RL
    benchmark). Observations are (42, 42, 1) uint8 frames — exercises the
    full image pipeline (CNN policy, frame normalization)
    without shipping game ROMs. Actions: 0=left 1=stay 2=right."""

    SIZE = 42
    observation_shape = (42, 42, 1)
    observation_size = 42 * 42  # flattened (MLP fallback)
    num_actions = 3

    def __init__(self):
        self.rng = np.random.default_rng(0)
        self.reset()

    def _frame(self) -> np.ndarray:
        f = np.zeros((self.SIZE, self.SIZE, 1), np.uint8)
        f[self.ball_y, self.ball_x, 0] = 255
        x0 = max(0, self.paddle_x - 2)
        x1 = min(self.SIZE, self.paddle_x + 3)
        f[self.SIZE - 1, x0:x1, 0] = 255
        return f

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.ball_x = int(self.rng.integers(0, self.SIZE))
        self.ball_y = 0
        self.paddle_x = self.SIZE // 2
        return self._frame()

    def step(self, action: int):
        self.paddle_x = int(np.clip(self.paddle_x + (int(action) - 1), 2,
                                    self.SIZE - 3))
        self.ball_y += 1
        done = self.ball_y >= self.SIZE - 1
        reward = 0.0
        if done:
            reward = 1.0 if abs(self.ball_x - self.paddle_x) <= 2 else -1.0
        return self._frame(), reward, done, {}


class MultiAgentEnv:
    """Multi-agent env interface (parity: reference rllib MultiAgentEnv):
    reset() -> {agent_id: obs}; step({agent_id: action}) ->
    (obs_dict, reward_dict, done_dict incl. '__all__', info_dict)."""

    agent_ids: tuple = ()

    def reset(self, seed: int | None = None) -> dict:
        raise NotImplementedError

    def step(self, actions: dict):
        raise NotImplementedError


class DualCartPole(MultiAgentEnv):
    """Two independent CartPole agents in one env — the minimal
    multi-agent scaffold (reference: rllib examples' multi-agent
    cartpole). Episode ends when BOTH poles have fallen."""

    agent_ids = ("agent_0", "agent_1")
    observation_size = 4
    num_actions = 2

    def __init__(self):
        self.envs = {a: CartPole() for a in self.agent_ids}
        self.done = {a: False for a in self.agent_ids}

    def reset(self, seed: int | None = None) -> dict:
        self.done = {a: False for a in self.agent_ids}
        return {a: e.reset(None if seed is None else seed + i)
                for i, (a, e) in enumerate(self.envs.items())}

    def step(self, actions: dict):
        obs, rew, done = {}, {}, {}
        for a, e in self.envs.items():
            if self.done[a]:
                continue
            o, r, d, _ = e.step(actions[a])
            obs[a], rew[a], done[a] = o, r, d
            self.done[a] = d
        done["__all__"] = all(self.done.values())
        return obs, rew, done, {}


_register_late()
