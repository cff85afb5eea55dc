"""Rainbow: DQN with the six classic extensions combined. Port of
ray_tpu/rllib/rainbow.py.

Parity: reference rllib/algorithms/dqn/ with the Rainbow options on
(DQNConfig: num_atoms>1 -> distributional C51, dueling=True,
noisy=True, n_step>1, prioritized replay; double-Q always) — the
reference exposes Rainbow as a DQN configuration, this module gives it
the dedicated driver the paper describes. The categorical projection,
dueling aggregation and factorized noisy layers run in `RainbowLearner`
on the card; sampling stays on CPU rollout actors like dqn.py.

The reference draws the noisy nets' normals with jax.random inside its
jitted update. The port's update takes them as an argument
(`RainbowLearner.draw_noise`, from a torch.Generator on the learner's
device seeded from config.seed), so a test can hand it the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import device_context
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import TorchLearner, device_batch, stop_actors
from ray_tpu_torch.rllib.replay import PrioritizedReplayBuffer
from ray_tpu_torch.rllib.utils import (CPUActor, tree_assign, tree_copy,
                                       tree_numpy)


def init_rainbow_params(obs_size: int, num_actions: int, num_atoms: int,
                        hidden: int = 64, seed: int = 0) -> dict:
    """Dueling trunk: shared hidden -> (value stream, advantage stream),
    each emitting per-atom logits; final heads are factorized-noisy
    (mu/sigma pairs, NoisyNet): params carry both."""
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o))
                      / np.sqrt(i)).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    def noisy(i, o):
        bound = 1.0 / np.sqrt(i)
        return {
            "w_mu": rng.uniform(-bound, bound, (i, o)).astype(np.float32),
            "w_sigma": np.full((i, o), 0.5 * bound, np.float32),
            "b_mu": rng.uniform(-bound, bound, o).astype(np.float32),
            "b_sigma": np.full(o, 0.5 * bound, np.float32),
        }

    return {"h1": dense(obs_size, hidden), "h2": dense(hidden, hidden),
            "value": noisy(hidden, num_atoms),
            "adv": noisy(hidden, num_actions * num_atoms)}


def _noisy_apply(layer, x, eps_in, eps_out):
    """Factorized Gaussian noise: eps_w = f(eps_in) f(eps_out)^T,
    f(x) = sign(x) sqrt(|x|) (NoisyNet eq. 10-11)."""
    fi = torch.sign(eps_in) * torch.sqrt(eps_in.abs())
    fo = torch.sign(eps_out) * torch.sqrt(eps_out.abs())
    w = layer["w_mu"] + layer["w_sigma"] * torch.outer(fi, fo)
    b = layer["b_mu"] + layer["b_sigma"] * fo
    return x @ w + b


def rainbow_logits(params, obs, eps, num_actions: int, num_atoms: int):
    """Per-action atom logits with dueling aggregation:
    logits(s,a) = value(s) + adv(s,a) - mean_a adv(s,a)."""
    h = torch.tanh(obs @ params["h1"]["w"] + params["h1"]["b"])
    h = torch.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    value = _noisy_apply(params["value"], h, eps["v_in"], eps["v_out"])
    adv = _noisy_apply(params["adv"], h, eps["a_in"], eps["a_out"])
    adv = adv.reshape(-1, num_actions, num_atoms)   # [B, A, atoms]
    return (value[:, None, :] + adv
            - adv.mean(dim=1, keepdim=True))        # [B, A, atoms]


def numpy_rainbow_q(params: dict, obs: np.ndarray, z: np.ndarray,
                    num_actions: int) -> np.ndarray:
    """Greedy-action Q for CPU rollouts: noise OFF (mu weights only),
    Q(s,a) = sum_i z_i p_i(s,a)."""
    num_atoms = len(z)
    h = np.tanh(obs @ params["h1"]["w"] + params["h1"]["b"])
    h = np.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    value = h @ params["value"]["w_mu"] + params["value"]["b_mu"]
    adv = (h @ params["adv"]["w_mu"] + params["adv"]["b_mu"]).reshape(
        -1, num_actions, num_atoms)
    logits = value[:, None, :] + adv - adv.mean(axis=1, keepdims=True)
    e = np.exp(logits - logits.max(axis=-1, keepdims=True))
    probs = e / e.sum(axis=-1, keepdims=True)
    return (probs * z).sum(axis=-1)


def categorical_projection(p_next, rewards, dones, z, gamma_n: float,
                           v_min: float, v_max: float):
    """C51's projection (eq. 7) of r + gamma^n z onto the support z, each
    row's mass split between the atoms below and above its point; where
    the point is an atom (lo == hi) all of it goes to lo. The reference's
    two .at[].add become index_add_ over the flattened [B, atoms] rows."""
    B, atoms = p_next.shape
    dz = (v_max - v_min) / (atoms - 1)
    tz = torch.clamp(rewards[:, None] + gamma_n
                     * (1.0 - dones[:, None]) * z[None, :], v_min, v_max)
    b = (tz - v_min) / dz
    lo = torch.floor(b).long()
    hi = torch.ceil(b).long()
    frac_hi = b - lo
    frac_lo = 1.0 - frac_hi
    row = torch.arange(B, device=p_next.device)[:, None] * atoms
    m = torch.zeros(B * atoms, dtype=p_next.dtype, device=p_next.device)
    m.index_add_(0, (row + lo).reshape(-1), (p_next * frac_lo).reshape(-1))
    m.index_add_(0, (row + torch.clamp(hi, max=atoms - 1)).reshape(-1),
                 (p_next * frac_hi).reshape(-1))
    return m.reshape(B, atoms)


@ray_tpu_torch.remote(num_cpus=1)
class RainbowRolloutWorker(CPUActor):
    """CPU sampler (parity: rollout_worker.py). Exploration comes from
    the noisy heads, not epsilon — rollouts act greedily on the
    noise-free (mu) distributionally-expected Q, with a tiny epsilon
    floor against early determinism."""

    def __init__(self, env_spec, worker_index: int, z):
        super().__init__()
        self.env = make_env(env_spec)
        self.index = worker_index
        self.z = np.asarray(z, np.float32)
        self.rng = np.random.default_rng(3000 + worker_index)
        self.obs = self.env.reset(seed=worker_index)
        self.ep_ret = 0.0

    def sample(self, params: dict, num_steps: int, epsilon: float) -> dict:
        obs_b, act_b, rew_b, next_b, done_b = [], [], [], [], []
        reset_b = []
        episode_returns = []
        for _ in range(num_steps):
            if self.rng.random() < epsilon:
                action = int(self.rng.integers(self.env.num_actions))
            else:
                q = numpy_rainbow_q(params, self.obs[None, :], self.z,
                                    self.env.num_actions)[0]
                action = int(np.argmax(q))
            next_obs, reward, done, info = self.env.step(action)
            obs_b.append(self.obs)
            act_b.append(action)
            rew_b.append(reward)
            next_b.append(next_obs)
            # Two signals: "dones" is the BOOTSTRAP mask — time-limit
            # cuts (info["truncated"]) still bootstrap through the cut
            # (gym TimeLimit convention, env.py) — while "resets" marks
            # where the episode actually ended (n-step folding must not
            # run across a reset into the next episode).
            done_b.append(float(bool(done)
                                and not info.get("truncated", False)))
            reset_b.append(float(done))
            self.ep_ret += reward
            if done:
                episode_returns.append(self.ep_ret)
                self.ep_ret = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        return {"obs": np.asarray(obs_b, np.float32),
                "actions": np.asarray(act_b, np.int32),
                "rewards": np.asarray(rew_b, np.float32),
                "next_obs": np.asarray(next_b, np.float32),
                "dones": np.asarray(done_b, np.float32),
                "resets": np.asarray(reset_b, np.float32),
                "episode_returns": episode_returns}


class _NStepBuffer(PrioritizedReplayBuffer):
    """Prioritized buffer fed n-step transitions: the rollout batch is
    rewritten so reward_t = sum_{k<n} gamma^k r_{t+k} and next_obs_t =
    obs_{t+n} (truncated at dones; reference: n_step folding in the
    DQN sample pipeline)."""

    def add_nstep(self, batch: dict, n: int, gamma: float) -> None:
        obs = batch["obs"]
        size = len(obs)
        rewards = np.zeros(size, np.float32)
        next_obs = np.array(batch["next_obs"])
        dones = np.zeros(size, np.float32)
        keep = np.ones(size, bool)
        resets = batch.get("resets", batch["dones"])
        for t in range(size):
            acc, discount = 0.0, 1.0
            folded = 0
            for k in range(n):
                j = t + k
                if j >= size:
                    break
                acc += discount * batch["rewards"][j]
                discount *= gamma
                folded += 1
                next_obs[t] = batch["next_obs"][j]
                if resets[j]:
                    # Episode boundary: never fold into the next episode.
                    # The bootstrap mask comes from the STOPPING step (a
                    # time-limit cut keeps bootstrapping, dones[j]=0).
                    dones[t] = batch["dones"][j]
                    break
            rewards[t] = acc
            # The update applies gamma^n to the bootstrap uniformly, so
            # any window cut short (fragment boundary, or a time-limit
            # cut that still bootstraps) would get the wrong discount —
            # drop those few transitions instead of biasing them.
            # Terminal stops are exact: the bootstrap term is zeroed.
            if folded < n and not dones[t]:
                keep[t] = False
        self.add_batch({"obs": obs[keep],
                        "actions": batch["actions"][keep],
                        "rewards": rewards[keep],
                        "next_obs": next_obs[keep],
                        "dones": dones[keep]})


@dataclass
class RainbowConfig:
    """Parity: rllib DQNConfig with the Rainbow switches on."""

    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 256
    buffer_capacity: int = 50_000
    train_batch_size: int = 128
    num_sgd_iter: int = 32
    gamma: float = 0.99
    lr: float = 1e-3
    hidden_size: int = 64
    target_network_update_freq: int = 4
    num_atoms: int = 51
    v_min: float = 0.0
    v_max: float = 200.0
    n_step: int = 3
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
                raise ValueError(f"unknown Rainbow option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "Rainbow":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return Rainbow(self, device=device)


NOISE_DRAWS = ("online", "next_online", "next_target")


class RainbowLearner(TorchLearner):
    """Rainbow's learner on one device: the noisy dueling C51 network and
    its target, one Adam step an update of the IS-weighted cross-entropy
    to the projected double-Q target. update(batch, noise) takes the
    noisy heads' normals, one draw (v_in, v_out, a_in, a_out) for each
    of NOISE_DRAWS: the online net on obs, on next_obs (to pick a*), and
    the target net on next_obs."""

    def __init__(self, config: RainbowConfig, obs_size: int,
                 num_actions: int, *, params: dict | None = None,
                 device=None):
        self.config = config
        self.num_actions = num_actions
        if params is None:
            params = init_rainbow_params(obs_size, num_actions,
                                         config.num_atoms, config.hidden_size,
                                         config.seed)
        super().__init__(params, None, config.lr, device)
        self.target = tree_copy(self.params)
        self.z = torch.as_tensor(np.linspace(
            config.v_min, config.v_max, config.num_atoms).astype(np.float32),
            device=self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(
            config.seed)

    def draw_noise(self) -> dict:
        """One update's normals from the learner's generator."""
        cfg, H = self.config, self.config.hidden_size
        A, atoms = self.num_actions, cfg.num_atoms
        sizes = {"v_in": H, "v_out": atoms, "a_in": H, "a_out": A * atoms}
        return {d: {k: torch.randn(n, generator=self._gen,
                                   device=self.device)
                    for k, n in sizes.items()} for d in NOISE_DRAWS}

    def update(self, minibatch: dict, noise: dict):
        """One Adam step. Returns the loss and the per-row cross-entropy
        (the new priorities) as device tensors."""
        cfg, A, atoms = self.config, self.num_actions, self.config.num_atoms
        with device_context(self.device):
            batch = device_batch(minibatch, self.device)
            noise = {d: device_batch(e, self.device) for d, e in noise.items()}
            self.optimizer.zero_grad(set_to_none=True)
            logits = rainbow_logits(self.params, batch["obs"],
                                    noise["online"], A, atoms)
            idx = batch["actions"].long()[:, None, None].expand(-1, 1, atoms)
            logits_a = logits.gather(1, idx)[:, 0]          # [B, atoms]
            with torch.no_grad():
                # Double-Q: online net (fresh noise) picks a*, target net
                # evaluates its distribution.
                next_online = rainbow_logits(self.params, batch["next_obs"],
                                             noise["next_online"], A, atoms)
                next_q = (torch.softmax(next_online, -1) * self.z).sum(-1)
                a_star = next_q.argmax(1)
                next_target = rainbow_logits(self.target, batch["next_obs"],
                                             noise["next_target"], A, atoms)
                p_next = torch.softmax(next_target.gather(
                    1, a_star[:, None, None].expand(-1, 1, atoms))[:, 0], -1)
                m = categorical_projection(
                    p_next, batch["rewards"], batch["dones"], self.z,
                    cfg.gamma ** cfg.n_step, cfg.v_min, cfg.v_max)
            ce = -(m * torch.log_softmax(logits_a, -1)).sum(-1)   # [B]
            loss = (batch["weights"] * ce).mean()
            loss.backward()
            self.optimizer.step()
        self.updates += 1
        return loss.detach(), ce.detach()

    def sync_target(self) -> None:
        tree_assign(self.target, self.params)


class Rainbow:
    """Algorithm driver (parity: Algorithm.step with Rainbow's DQN
    training_step): noisy-net exploration (no epsilon schedule),
    distributional double-Q target projection, prioritized sampling with
    IS weights, priorities updated from the categorical TD error. The
    learner is made before the rollout workers."""

    def __init__(self, config: RainbowConfig, device=None):
        self.config = config
        probe = make_env(config.env)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.z = np.linspace(config.v_min, config.v_max,
                             config.num_atoms).astype(np.float32)
        self.learner = RainbowLearner(config, self.obs_size, self.num_actions,
                                      device=device)
        self.buffer = _NStepBuffer(config.buffer_capacity, self.obs_size,
                                   config.seed)
        self.workers = [RainbowRolloutWorker.remote(config.env, i, self.z)
                        for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def train(self) -> dict:
        """One iteration: parallel rollouts -> n-step prioritized buffer
        -> num_sgd_iter distributional updates -> priority sync."""
        cfg = self.config
        rollout_params = tree_numpy(self.learner.params)
        outs = ray_tpu_torch.get([
            w.sample.remote(rollout_params, cfg.rollout_fragment_length,
                            0.02)  # tiny epsilon floor; noise explores
            for w in self.workers])
        returns = []
        for out in outs:
            self.buffer.add_nstep(out, cfg.n_step, cfg.gamma)
            returns += out["episode_returns"]
            self.total_steps += len(out["obs"])
        losses = []
        if self.buffer.size >= cfg.train_batch_size:
            for _ in range(cfg.num_sgd_iter):
                batch = self.buffer.sample(cfg.train_batch_size)
                jb = {k: v for k, v in batch.items() if k != "indices"}
                loss, ce = self.learner.update(jb, self.learner.draw_noise())
                self.buffer.update_priorities(batch["indices"],
                                              ce.cpu().numpy())
                losses.append(float(loss))
        self.iteration += 1
        if self.iteration % cfg.target_network_update_freq == 0:
            self.learner.sync_target()
        return {"training_iteration": self.iteration,
                "episode_reward_mean":
                    float(np.mean(returns)) if returns else float("nan"),
                "num_env_steps_sampled": self.total_steps,
                "loss": float(np.mean(losses)) if losses else None}

    def stop(self):
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return self.learner.get_params()
