"""APPO: asynchronous PPO — IMPALA's async sampling architecture with the
PPO clipped-surrogate objective on V-trace-corrected advantages. Port of
ray_tpu/rllib/appo.py.

Parity: reference rllib/algorithms/appo/ (appo.py, appo_torch_policy.py) —
APPO is IMPALA's actor/learner split where the learner applies the PPO
clip to importance ratios (behavior vs current policy) instead of the
plain V-trace policy-gradient, plus a slowly-updated target network used
as the clipping anchor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.impala import (Impala, ImpalaConfig, mlp_forward,
                                        vtrace)
from ray_tpu_torch.rllib.ppo import TorchLearner, tensor_params


@dataclass
class APPOConfig(ImpalaConfig):
    """Fluent config (parity: rllib APPOConfig)."""

    clip_param: float = 0.2
    use_kl_loss: bool = False
    kl_coeff: float = 0.2
    kl_target: float = 0.01
    target_update_freq: int = 4   # learner steps between target syncs

    def build(self, device=None) -> "APPO":
        return APPO(self, device=device)


def make_appo_loss(cfg: APPOConfig, target: dict):
    """APPO's loss over the learner's params, the V-trace targets taken
    from the target network's params `target` (read at each call)."""

    def loss_fn(params, batch):
        logits, values = mlp_forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        actions = batch["actions"].long()[:, None]
        logp = logp_all.gather(1, actions)[:, 0]

        # V-trace targets/advantages computed with the *target* network
        # (the stable anchor; reference: appo uses target for v-trace).
        with torch.no_grad():
            t_logits, t_values = mlp_forward(target, batch["obs"])
            t_logp_all = torch.log_softmax(t_logits, dim=-1)
            t_logp = t_logp_all.gather(1, actions)[:, 0]
            _, t_boot_v = mlp_forward(target, batch["bootstrap_obs"][None, :])
            t_rhos = torch.exp(t_logp - batch["behavior_logp"])
        vs, pg_adv = vtrace(t_values, t_boot_v[0], batch["rewards"],
                            batch["dones"], t_rhos, gamma=cfg.gamma,
                            clip_rho=cfg.vtrace_clip_rho,
                            clip_c=cfg.vtrace_clip_c)
        adv = (pg_adv - pg_adv.mean()) / (pg_adv.std(correction=0) + 1e-8)

        # PPO clip on the current/behavior ratio.
        ratio = torch.exp(logp - batch["behavior_logp"])
        clipped = torch.clamp(ratio, 1 - cfg.clip_param, 1 + cfg.clip_param)
        pi_loss = -torch.minimum(ratio * adv, clipped * adv).mean()
        vf_loss = ((values - vs) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pi_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        aux = {"pi_loss": pi_loss, "vf_loss": vf_loss, "entropy": entropy,
               "mean_ratio": ratio.detach().mean()}
        if cfg.use_kl_loss:
            kl = (torch.exp(t_logp_all) * (t_logp_all - logp_all)).sum(-1) \
                .mean()
            total = total + cfg.kl_coeff * kl
            aux["kl"] = kl
        return total, aux

    return loss_fn


class APPOLearner(TorchLearner):
    """IMPALA's learner with APPO's loss and its target network: a copy
    of the params, taken again every target_update_freq updates."""

    def __init__(self, params: dict, cfg: APPOConfig, device=None):
        device = resolve_device(device)
        self.target = tensor_params(params, device)
        super().__init__(params, make_appo_loss(cfg, self.target), cfg.lr,
                         device)
        self._freq = cfg.target_update_freq
        self._steps_since_sync = 0

    def update(self, minibatch: dict):
        out = super().update(minibatch)
        self._steps_since_sync += 1
        if self._steps_since_sync >= self._freq:
            with torch.no_grad():
                for k, sub in self.params.items():
                    for kk, t in sub.items():
                        self.target[k][kk].copy_(t)
            self._steps_since_sync = 0
        return out


class APPO(Impala):
    """Async PPO driver. Inherits IMPALA's in-flight fragment pipeline;
    only the learner's update differs."""

    def _make_learner(self, params: dict, device) -> TorchLearner:
        return APPOLearner(params, self.config, device)
