"""Connector pipelines: composable transforms between env and module. Port of
ray_tpu/rllib/connectors.py, a copy (numpy only).

Parity: reference rllib/connectors/ — env-to-module connectors transform
raw observations before the policy forward, module-to-env connectors
transform policy outputs into env actions. Pipelines are pure functions
over numpy data with a small amount of carried state (e.g. frame stacks,
running normalizer moments), so they run identically inside CPU rollout
actors and at serving time — the reference's portability argument for
connectors over ad-hoc preprocessing.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class Connector:
    """One transform. env-to-module: __call__(obs) -> obs.
    module-to-env: __call__(action) -> action. Stateful connectors carry
    their state on self and expose reset()."""

    def __call__(self, x: Any) -> Any:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def state(self) -> dict:
        """Serializable state (checkpointing parity: connectors travel
        with policies)."""
        return {}

    def set_state(self, state: dict) -> None:
        pass


class ConnectorPipeline(Connector):
    def __init__(self, connectors: list[Connector] | None = None):
        self.connectors = list(connectors or [])

    def append(self, c: Connector) -> "ConnectorPipeline":
        self.connectors.append(c)
        return self

    def __call__(self, x):
        for c in self.connectors:
            x = c(x)
        return x

    def reset(self):
        for c in self.connectors:
            c.reset()

    def state(self):
        return {i: c.state() for i, c in enumerate(self.connectors)}

    def set_state(self, state):
        for i, c in enumerate(self.connectors):
            if i in state or str(i) in state:
                c.set_state(state.get(i, state.get(str(i), {})))


# ---------------- env-to-module connectors ----------------


class FlattenObs(Connector):
    def __call__(self, obs):
        return np.asarray(obs, np.float32).reshape(-1)


class NormalizeObs(Connector):
    """Running mean/std normalization (Welford). State travels with the
    policy so evaluation uses the training moments."""

    def __init__(self, eps: float = 1e-8, clip: float = 10.0):
        self.eps = eps
        self.clip = clip
        self.count = 0.0
        self.mean: np.ndarray | None = None
        self.m2: np.ndarray | None = None
        self.frozen = False

    def __call__(self, obs):
        x = np.asarray(obs, np.float64)
        if self.mean is None:
            self.mean = np.zeros_like(x)
            self.m2 = np.ones_like(x)
        if not self.frozen:
            self.count += 1.0
            delta = x - self.mean
            self.mean = self.mean + delta / self.count
            self.m2 = self.m2 + delta * (x - self.mean)
        var = self.m2 / max(self.count, 2.0)
        out = (x - self.mean) / np.sqrt(var + self.eps)
        return np.clip(out, -self.clip, self.clip).astype(np.float32)

    def state(self):
        return {"count": self.count,
                "mean": None if self.mean is None else self.mean.tolist(),
                "m2": None if self.m2 is None else self.m2.tolist()}

    def set_state(self, state):
        self.count = state.get("count", 0.0)
        self.mean = None if state.get("mean") is None \
            else np.asarray(state["mean"])
        self.m2 = None if state.get("m2") is None else np.asarray(state["m2"])


class FrameStack(Connector):
    """Stack the last k observations along the last axis (Atari-style
    temporal context without a recurrent module)."""

    def __init__(self, k: int = 4):
        self.k = k
        self._frames: list = []

    def __call__(self, obs):
        obs = np.asarray(obs, np.float32)
        if not self._frames:
            self._frames = [obs] * self.k
        else:
            self._frames = self._frames[1:] + [obs]
        return np.concatenate(self._frames, axis=-1)

    def reset(self):
        self._frames = []


# ---------------- module-to-env connectors ----------------


class ClipActions(Connector):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, action):
        return np.clip(action, self.low, self.high)


class RescaleActions(Connector):
    """[-1, 1] policy outputs to the env's action bounds."""

    def __init__(self, low, high):
        low, high = np.asarray(low, np.float32), np.asarray(high, np.float32)
        self.mid = (low + high) / 2.0
        self.scale = (high - low) / 2.0

    def __call__(self, action):
        return self.mid + self.scale * np.asarray(action, np.float32)
