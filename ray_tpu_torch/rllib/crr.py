"""CRR: Critic-Regularized Regression (offline RL). Port of
ray_tpu/rllib/crr.py.

Parity: reference rllib/algorithms/crr/ — learn a Q critic on the
logged transitions, then imitate only advantage-positive actions:
policy loss = -w(s,a) * log pi(a|s) with w = exp(A/beta) ("exp" mode,
clipped) or w = 1[A > 0] ("binary" mode). Sits between BC (no critic)
and CQL (pessimistic critic + SAC) in the offline family.

Discrete-action variant over the same JSONL/Dataset inputs as
BC/MARWIL (the port's offline.py, whose MARWIL it extends); the critic's
advantage baseline is the policy-expected Q under the current policy
distribution. The policy and the critic (dqn.init_q_params) are f32
tensors on the learner's device, each with its own Adam.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ray_tpu_torch._device import device_context
from ray_tpu_torch.rllib.dqn import init_q_params, q_values, take
from ray_tpu_torch.rllib.offline import MARWIL, MARWILConfig
from ray_tpu_torch.rllib.ppo import adam, device_batch, tensor_params
from ray_tpu_torch.rllib.utils import tree_assign, tree_copy


@dataclass
class CRRConfig(MARWILConfig):
    """Fluent config (parity: rllib CRRConfig)."""

    weight_mode: str = "exp"      # "exp" | "binary"
    beta: float = 1.0             # temperature for exp weights
    weight_clip: float = 20.0
    critic_lr: float = 1e-3
    target_update_freq: int = 4   # iterations between critic target syncs

    def build(self, device=None) -> "CRR":  # type: ignore[override]
        return CRR(self, device=device)


def pi_logits(params, obs):
    """The policy head of MARWIL's actor-critic MLP."""
    h = torch.tanh(obs @ params["h1"]["w"] + params["h1"]["b"])
    h = torch.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    return h @ params["pi"]["w"] + params["pi"]["b"]


class CRR(MARWIL):
    """The offline learner: MARWIL's policy and Adam (`params`,
    `optimizer`) and a Q critic with its target and its own Adam
    (`q_params`, `q_target`, `q_optimizer`). device: None means CUDA and
    raises without a card."""

    def __init__(self, config: CRRConfig, device=None):
        super().__init__(config, device=device)
        self.q_params = tensor_params(init_q_params(
            self.obs_size, self.num_actions, config.hidden_size,
            config.seed + 1), self.device, trainable=True)
        self.q_target = tree_copy(self.q_params)
        self.q_optimizer = adam(self.q_params, config.critic_lr)

    def _q_loss(self, batch):
        cfg = self.config
        q_sel = take(q_values(self.q_params, batch["obs"]), batch["actions"])
        with torch.no_grad():
            # SARSA-style bootstrap through the CURRENT policy's
            # expectation at s' (the offline-safe choice: no max over
            # out-of-distribution actions).
            probs_next = torch.softmax(pi_logits(self.params,
                                                 batch["next_obs"]), -1)
            v_next = (probs_next * q_values(self.q_target,
                                            batch["next_obs"])).sum(-1)
            target = batch["rewards"] + cfg.gamma * \
                (1.0 - batch["dones"]) * v_next
        return ((q_sel - target) ** 2).mean()

    def _pi_loss(self, batch):
        cfg = self.config
        logits = pi_logits(self.params, batch["obs"])
        logp = take(torch.log_softmax(logits, -1), batch["actions"])
        with torch.no_grad():
            q = q_values(self.q_params, batch["obs"])
            v = (torch.softmax(logits, -1) * q).sum(-1)
            adv = take(q, batch["actions"]) - v
            if cfg.weight_mode == "binary":
                w = (adv > 0).to(torch.float32)
            else:
                w = torch.clamp(torch.exp(adv / cfg.beta),
                                max=cfg.weight_clip)
        return -(w * logp).mean()

    def update(self, minibatch: dict):
        """One critic step, then one policy step against the new critic.
        Returns (critic loss, policy loss) as device tensors."""
        with device_context(self.device):
            batch = device_batch(minibatch, self.device)
            self.q_optimizer.zero_grad(set_to_none=True)
            ql = self._q_loss(batch)
            ql.backward()
            self.q_optimizer.step()
            self.optimizer.zero_grad(set_to_none=True)
            pl = self._pi_loss(batch)
            pl.backward()
            self.optimizer.step()
        return ql.detach(), pl.detach()

    def train(self) -> dict:
        cfg: CRRConfig = self.config  # type: ignore[assignment]
        t0 = time.time()
        n = len(self.data["obs"])
        rng = np.random.default_rng(cfg.seed + self.iteration)
        q_losses, pi_losses = [], []
        for _ in range(cfg.num_sgd_iter_per_train):
            idx = rng.integers(0, n, cfg.train_batch_size)
            # Logged steps are sequential, so obs[i+1] is next_obs within
            # an episode; at boundaries (dones=1) the bootstrap is masked,
            # so the wrong-next-obs there never enters the target.
            batch = {
                "obs": self.data["obs"][idx],
                "actions": self.data["actions"][idx],
                "rewards": self.data["rewards"][idx],
                "next_obs": self.data["obs"][np.minimum(idx + 1, n - 1)],
                "dones": self.data["dones"][idx].astype(np.float32),
            }
            ql, pl = self.update(batch)
            q_losses.append(ql)
            pi_losses.append(pl)
        self.iteration += 1
        if self.iteration % cfg.target_update_freq == 0:
            tree_assign(self.q_target, self.q_params)
        return {
            "training_iteration": self.iteration,
            "critic_loss": float(np.mean(torch.stack(q_losses).tolist())),
            "policy_loss": float(np.mean(torch.stack(pi_losses).tolist())),
            "num_samples_trained": cfg.num_sgd_iter_per_train
            * cfg.train_batch_size,
            "iter_time_s": round(time.time() - t0, 3),
        }
