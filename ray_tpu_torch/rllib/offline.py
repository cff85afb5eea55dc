"""Offline RL: behavior cloning (BC) and MARWIL from logged experience.
Port of ray_tpu/rllib/offline.py.

Parity: reference rllib/offline/ (json_reader.py, the BC and MARWIL
algorithms under rllib/algorithms/{bc,marwil}/). Experience is consumed
from JSONL sample files (the same bytes as the reference writes, so each
package reads the other's) or a list of row dicts; no environment
interaction is needed to train (an env is only used for optional
evaluation rollouts). The policy is PPO's MLP actor-critic; training
runs on the device, evaluation runs the numpy forward on the learned
params, as the reference does.

MARWIL (Wang et al. 2018) generalizes BC: actions are weighted by
exp(beta * advantage); beta=0 reduces to plain BC (reference:
rllib/algorithms/marwil/marwil.py — BC subclasses MARWIL with beta=0).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.rllib.catalog import get_model
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import (init_policy_params, leaves,
                                     numpy_forward, numpy_params,
                                     tensor_params)


def write_offline_json(path: str, batches: list[dict]) -> None:
    """Log sample batches to a JSONL file readable by JsonReader
    (reference: rllib/offline/json_writer.py)."""
    with open(path, "w") as f:
        for b in batches:
            f.write(json.dumps({
                "obs": np.asarray(b["obs"], np.float32).tolist(),
                "actions": np.asarray(b["actions"], np.int32).tolist(),
                "rewards": np.asarray(b.get(
                    "rewards", np.zeros(len(b["obs"]))), np.float32).tolist(),
                "dones": np.asarray(b.get(
                    "dones", np.zeros(len(b["obs"]))), np.float32).tolist(),
            }) + "\n")


class JsonReader:
    """Reads logged experience (reference: rllib/offline/json_reader.py)."""

    def __init__(self, path: str):
        self.paths = ([os.path.join(path, p) for p in sorted(os.listdir(path))]
                      if os.path.isdir(path) else [path])

    def read_all(self) -> dict:
        fields = {"obs": [], "actions": [], "rewards": [], "dones": []}
        for p in self.paths:
            with open(p) as f:
                for line in f:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    for k in fields:
                        fields[k].extend(rec.get(k, []))
        return {
            "obs": np.asarray(fields["obs"], np.float32),
            "actions": np.asarray(fields["actions"], np.int32),
            "rewards": np.asarray(fields["rewards"], np.float32),
            "dones": np.asarray(fields["dones"], np.float32),
        }


@dataclass
class MARWILConfig:
    """Fluent config (parity: rllib MARWILConfig)."""

    env: Any = "CartPole-v1"   # for obs/action spaces + optional eval
    input_path: str | None = None   # JSONL file/dir of logged experience
    input_dataset: Any = None       # or a list of row dicts
    beta: float = 1.0               # 0 => behavior cloning
    gamma: float = 0.99
    vf_coeff: float = 1.0
    train_batch_size: int = 512
    num_sgd_iter_per_train: int = 10
    lr: float = 1e-3
    hidden_size: int = 64
    seed: int = 0

    def environment(self, env):
        self.env = env
        return self

    def offline_data(self, input_path: str | None = None, input_dataset=None):
        self.input_path = input_path
        self.input_dataset = input_dataset
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown MARWIL option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "MARWIL":
        return MARWIL(self, device=device)


@dataclass
class BCConfig(MARWILConfig):
    """Behavior cloning = MARWIL with beta=0 (reference: rllib BC)."""

    beta: float = 0.0

    def build(self, device=None) -> "BC":
        return BC(self, device=device)


def marwil_loss(params: dict, batch: dict, beta: float, vf_coeff: float):
    """The MARWIL loss over PPO's MLP policy: (total, {"pi_loss",
    "vf_loss", "mean_weight"}); beta 0 is plain BC."""
    logits, value = get_model("mlp").torch_forward(params, batch["obs"])
    logp_all = torch.log_softmax(logits, dim=-1)
    logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
    if beta == 0.0:
        weight = torch.ones_like(logp)     # plain BC
        vf_loss = torch.zeros((), device=logp.device)
    else:
        adv = batch["returns"] - value
        weight = torch.exp(beta * (adv / (adv.abs().mean() + 1e-8)).detach())
        vf_loss = (adv ** 2).mean()
    pi_loss = -(weight * logp).mean()
    total = pi_loss + vf_coeff * vf_loss
    return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                   "mean_weight": weight.mean()}


class MARWIL:
    """Offline learner: advantage-weighted action imitation. device: None
    means CUDA and raises without a card."""

    def __init__(self, config: MARWILConfig, device=None):
        self.device = resolve_device(device)
        self.config = config
        probe = make_env(config.env)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.params = tensor_params(init_policy_params(
            self.obs_size, self.num_actions, config.hidden_size, config.seed),
            self.device, trainable=True)
        self.optimizer = torch.optim.Adam(leaves(self.params), lr=config.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.data = self._load_data()
        self._ret = None
        self._device_data = None
        self.iteration = 0

    def _load_data(self) -> dict:
        cfg = self.config
        if cfg.input_dataset is not None:
            rows = cfg.input_dataset.take_all() \
                if hasattr(cfg.input_dataset, "take_all") else list(cfg.input_dataset)
            return {
                "obs": np.asarray([r["obs"] for r in rows], np.float32),
                "actions": np.asarray([r["actions"] for r in rows], np.int32),
                "rewards": np.asarray(
                    [r.get("rewards", 0.0) for r in rows], np.float32),
                "dones": np.asarray(
                    [r.get("dones", 0.0) for r in rows], np.float32),
            }
        if cfg.input_path is not None:
            return JsonReader(cfg.input_path).read_all()
        raise ValueError("MARWIL/BC needs input_path or input_dataset")

    def _returns(self) -> np.ndarray:
        """Discounted reward-to-go per step (targets for the value head and
        the MARWIL advantage baseline)."""
        cfg = self.config
        rews, dones = self.data["rewards"], self.data["dones"]
        out = np.zeros(len(rews), np.float32)
        acc = 0.0
        for t in range(len(rews) - 1, -1, -1):
            acc = rews[t] + cfg.gamma * acc * (1.0 - dones[t])
            out[t] = acc
        return out

    def update(self, minibatch: dict):
        """One Adam step on a minibatch of tensors on the device ("obs",
        "actions", "returns"). Returns the loss and aux as device
        tensors."""
        cfg = self.config
        self.optimizer.zero_grad(set_to_none=True)
        loss, aux = marwil_loss(self.params, minibatch, cfg.beta,
                                cfg.vf_coeff)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def train(self) -> dict:
        cfg = self.config
        if self._ret is None:
            self._ret = self._returns()
            self._device_data = {
                k: torch.from_numpy(v).to(self.device) for k, v in
                (("obs", self.data["obs"]), ("actions", self.data["actions"]),
                 ("returns", self._ret))}
        rng = np.random.default_rng(cfg.seed + self.iteration)
        n = len(self.data["obs"])
        t0 = time.time()
        aux, losses = {}, []
        with device_context(self.device):
            for _ in range(cfg.num_sgd_iter_per_train):
                idx = torch.from_numpy(rng.integers(
                    0, n, min(cfg.train_batch_size, n))).to(self.device)
                loss, aux = self.update({k: v[idx] for k, v in
                                         self._device_data.items()})
                losses.append(loss)
            loss = float(np.mean(torch.stack(losses).tolist()))  # one read
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "loss": loss,
            "num_samples": n,
            "iter_time_s": round(time.time() - t0, 3),
            **{k: float(v) for k, v in aux.items()},
        }

    def evaluate(self, num_episodes: int = 5) -> dict:
        """Greedy-policy rollouts in the config env."""
        env = make_env(self.config.env)
        params = self.get_policy_params()
        returns = []
        for ep in range(num_episodes):
            obs = env.reset(seed=10_000 + ep)
            done, total = False, 0.0
            while not done:
                logits, _ = numpy_forward(params, obs[None, :])
                obs, r, done, _ = env.step(int(np.argmax(logits[0])))
                total += r
            returns.append(total)
        return {"episode_reward_mean": float(np.mean(returns)),
                "episodes": num_episodes}

    def stop(self):
        pass

    def get_policy_params(self) -> dict:
        return numpy_params(self.params)

    def compute_single_action(self, obs) -> int:
        logits, _ = numpy_forward(self.get_policy_params(), obs[None, :])
        return int(np.argmax(logits[0]))


class BC(MARWIL):
    """Behavior cloning (reference: rllib/algorithms/bc/)."""
