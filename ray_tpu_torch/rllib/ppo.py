"""PPO's learner. Port of ray_tpu/rllib/ppo.py: the policy's numpy half,
GAE, the config, the clipped-surrogate loss and the learner's update.

Parity: reference rllib/algorithms/ppo/. The reference splits an
iteration into rollouts on CPU actors (`RolloutWorker`, numpy forward)
and minibatch SGD on the learner; `PPOLearner` is that learner: the
policy's params as f32 tensors on the device, `torch.optim.Adam` (the
defaults of optax.adam), `update` one minibatch step and `learn` the SGD
epochs of `PPO.train` over a sampled batch. The rollout actors, the
`PPO` algorithm and the distributed `LearnerGroup` need the runtime and
are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.rllib.catalog import get_model


# ---------------- policy: MLP actor-critic ----------------


def init_policy_params(obs_size: int, num_actions: int, hidden: int = 64,
                       seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    return {
        "h1": dense(obs_size, hidden),
        "h2": dense(hidden, hidden),
        "pi": dense(hidden, num_actions),
        "vf": dense(hidden, 1),
    }


def numpy_forward(params: dict, obs: np.ndarray):
    """Policy forward pass used inside rollout workers."""
    h = np.tanh(obs @ params["h1"]["w"] + params["h1"]["b"])
    h = np.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


def _gae(rews, vals, dones, gamma, lam):
    """Generalized advantage estimation over one fragment; vals has the
    bootstrap value appended."""
    n = len(rews)
    adv = np.zeros(n, np.float32)
    last = 0.0
    for t in range(n - 1, -1, -1):
        nonterminal = 0.0 if dones[t] else 1.0
        delta = rews[t] + gamma * vals[t + 1] * nonterminal - vals[t]
        last = delta + gamma * lam * nonterminal * last
        adv[t] = last
    return adv, adv + vals[:-1]


@dataclass
class PPOConfig:
    """Parity: rllib AlgorithmConfig/PPOConfig fluent-config object. The
    reference's `build()` makes the PPO algorithm, which needs the runtime;
    here a config feeds `PPOLearner`."""

    env: Any = "CartPole-v1"
    num_rollout_workers: int = 2
    rollout_fragment_length: int = 512
    train_batch_size: int = 1024
    num_sgd_iter: int = 6
    sgd_minibatch_size: int = 256
    gamma: float = 0.99
    lam: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    lr: float = 3e-4
    # None -> the catalog model's own default width.
    hidden_size: int | None = None
    seed: int = 0
    # Catalog model name ("mlp", "resmlp", "atari_cnn" for pixel envs).
    model: str = "mlp"
    # >1: updates run on a LearnerGroup of remote learner actors with
    # ring-allreduced gradients (reference: learner_group.py remote
    # learners + DDP sync); 1 = in-process update.
    num_learners: int = 1
    # Multi-agent (parity: reference .multi_agent(policies=...,
    # policy_mapping_fn=...)): policy_id -> None; mapping agent_id ->
    # policy_id. None = single-agent.
    policies: Any = None
    policy_mapping_fn: Any = None

    def environment(self, env):
        self.env = env
        return self

    def rollouts(self, num_rollout_workers: int = None, **kw):
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown PPO option {k!r}")
            setattr(self, k, v)
        return self

    def multi_agent(self, *, policies: dict, policy_mapping_fn):
        self.policies = dict(policies)
        self.policy_mapping_fn = policy_mapping_fn
        return self


def make_ppo_loss(forward, clip_param: float, vf_coeff: float,
                  entropy_coeff: float):
    """The PPO clipped-surrogate loss as a free function (reference:
    Learner.compute_loss, rllib/core/learner/learner.py):
    loss_fn(params, batch) -> (total, {"pi_loss", "vf_loss", "entropy"}).
    The advantages are normalized by their population std, as jnp.std
    computes it (torch's default divides by n - 1)."""

    def loss_fn(params, batch):
        logits, value = forward(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = logp_all.gather(1, batch["actions"].long()[:, None])[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        clipped = torch.clamp(ratio, 1 - clip_param, 1 + clip_param)
        pi_loss = -torch.minimum(ratio * adv, clipped * adv).mean()
        vf_loss = ((value - batch["returns"]) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pi_loss + vf_coeff * vf_loss - entropy_coeff * entropy
        return total, {"pi_loss": pi_loss, "vf_loss": vf_loss,
                       "entropy": entropy}

    return loss_fn


def tensor_params(params: dict, device, trainable: bool = False) -> dict:
    """A params tree of numpy arrays as f32 tensors on `device`."""
    return {k: tensor_params(v, device, trainable) if isinstance(v, dict)
            else torch.tensor(np.asarray(v, np.float32), device=device,
                              requires_grad=trainable)
            for k, v in params.items()}


def numpy_params(params: dict) -> dict:
    """A params tree of tensors as numpy arrays (for the numpy forward)."""
    return {k: numpy_params(v) if isinstance(v, dict)
            else v.detach().cpu().numpy() for k, v in params.items()}


def leaves(params: dict) -> list:
    """The tree's tensors, in its keys' order."""
    return [t for v in params.values()
            for t in (leaves(v) if isinstance(v, dict) else [v])]


class PPOLearner:
    """The learner half of PPO on one device.

    obs_in: the observation size (an int), or for "atari_cnn" the
    observation shape (H, W, C). params: a numpy params tree (the
    catalog's init from config.seed when None). device: None means CUDA
    and raises without a card."""

    def __init__(self, config: PPOConfig, obs_in, num_actions: int, *,
                 params: dict | None = None, device=None):
        self.device = resolve_device(device)
        self.config = config
        spec = get_model(config.model)
        hidden = config.hidden_size or spec.default_hidden
        if params is None:
            params = spec.init_params(obs_in, num_actions, hidden,
                                      config.seed)
        self.params = tensor_params(params, self.device, trainable=True)
        self.optimizer = torch.optim.Adam(leaves(self.params), lr=config.lr,
                                          betas=(0.9, 0.999), eps=1e-8)
        self._loss_fn = make_ppo_loss(spec.torch_forward,
                                      config.clip_param, config.vf_coeff,
                                      config.entropy_coeff)
        self.updates = 0

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def update(self, minibatch: dict):
        """One Adam step on the minibatch ("obs", "actions", "logp",
        "advantages", "returns"; numpy arrays or tensors). Returns the
        loss and the aux terms as device tensors; the grads stay in the
        params' .grad until the next update."""
        with device_context(self.device):
            batch = self._batch(minibatch)
            self.optimizer.zero_grad(set_to_none=True)
            loss, aux = self._loss_fn(self.params, batch)
            loss.backward()
            self.optimizer.step()
        self.updates += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def learn(self, batch: dict, iteration: int) -> dict:
        """The SGD half of one PPO iteration: num_sgd_iter epochs of
        minibatches over the batch, each epoch's order a permutation from
        default_rng(seed + iteration), as PPO.train draws it. The batch
        moves to the device once. Returns the last minibatch's loss terms
        as floats (the one host read)."""
        cfg = self.config
        n = len(batch["obs"])
        rng = np.random.default_rng(cfg.seed + iteration)
        with device_context(self.device):
            data = self._batch(batch)
            aux = {}
            for _ in range(cfg.num_sgd_iter):
                perm = torch.from_numpy(rng.permutation(n)).to(self.device)
                for s in range(0, n, cfg.sgd_minibatch_size):
                    idx = perm[s: s + cfg.sgd_minibatch_size]
                    _loss, aux = self.update({k: v[idx]
                                              for k, v in data.items()})
            return {k: float(v) for k, v in aux.items()}

    def get_params(self) -> dict:
        """The params as numpy arrays, for the numpy forward."""
        return numpy_params(self.params)
