"""DreamerV3: model-based RL — world model + actor-critic in imagination.
Port of ray_tpu/rllib/dreamerv3.py.

Parity: reference rllib/algorithms/dreamerv3/ (an RSSM world model,
imagination-trained actor-critic). Core DreamerV3 signatures kept from
the paper (Hafner et al., 2023): symlog predictions, categorical latents
with straight-through gradients, free-bits KL with dyn/rep balancing,
percentile return normalization, EMA slow critic.

One update is the reference's fused one, eager on the learner's device:
the sequence model unrolled as a loop over the batch length, the
KL-balanced world-model loss, the H-step imagination under no_grad from
the filter's detached states, lambda-returns as a reversed loop, and the
actor and critic losses, each reaching only its own head. One backward
of their sum gives every leaf the gradient the reference's summed grads
give it, and one torch Adam with three param groups (model, actor,
critic, at their rates) is optax.multi_transform's three Adams. The
GRU cell is the reference's (u * c + (1 - u) * h, the reset gate on
the candidate's recurrent half), not nn.GRUCell.

Randomness. The reference draws its categoricals with jax.random inside
its jitted functions; jax.random.categorical(key, logits) is
argmax(logits + gumbel). Here the Gumbel noise is an argument: update()
takes it as {"post": (L, B, G, C), "act": (H, N, na), "prior": (H, N,
G, C)} (N = B * L imagined starts) and act() as (1, G, C) and (1, na);
train() and the env loop draw it from a torch.Generator on the learner's
device seeded from config.seed.

The env loop runs in-process with act() on the device (the policy is the
world model's filter state, so sampling needs the model — the
reference's DreamerV3 EnvRunner holds the RSSM too); the filter state
stays on the device between steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.rllib.dqn import take
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.ppo import (device_batch, load_adam_state,
                                     load_tree, tensor_params)
from ray_tpu_torch.rllib.utils import tree_copy

LABELS = ("model", "actor", "critic")


def _symlog(x):
    return torch.sign(x) * torch.log1p(torch.abs(x))


def _symexp(x):
    return torch.sign(x) * (torch.exp(torch.abs(x)) - 1.0)


@dataclass
class DreamerV3Config:
    """Fluent config (parity: DreamerV3Config in the reference)."""

    env: Any = "CartPole-v1"
    # World model sizes (reference XS-ish; CartPole-class defaults).
    deter: int = 128
    stoch_groups: int = 8
    stoch_classes: int = 8
    hidden: int = 128
    # Replay + schedule.
    replay_capacity: int = 100_000
    batch_size: int = 16
    batch_length: int = 16
    env_steps_per_iter: int = 500
    updates_per_iter: int = 30
    warmup_steps: int = 500
    # Horizons / discounts.
    imag_horizon: int = 15
    gamma: float = 0.997
    lam: float = 0.95
    # Losses.
    beta_pred: float = 1.0
    beta_dyn: float = 0.5
    beta_rep: float = 0.1
    free_bits: float = 1.0
    entropy_coeff: float = 3e-3
    critic_ema_decay: float = 0.98
    # Optim.
    model_lr: float = 1e-3
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    seed: int = 0

    def environment(self, env):
        self.env = env
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown DreamerV3 option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "DreamerV3":
        """device: where the world model and the actor-critic run; None
        means the card, and raises without one."""
        return DreamerV3(self, device=device)


class _SeqReplay:
    """Uniform sequence replay over one continuous stream per env
    (parity: reference dreamerv3 EpisodeReplayBuffer, simplified to a
    ring of transitions with episode-boundary `is_first` flags)."""

    def __init__(self, capacity: int, obs_size: int, num_actions: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_size), np.float32)
        self.action = np.zeros((capacity,), np.int32)
        self.reward = np.zeros((capacity,), np.float32)
        self.cont = np.zeros((capacity,), np.float32)
        self.is_first = np.zeros((capacity,), np.float32)
        self.n = 0
        self.ptr = 0

    def add(self, obs, action, reward, cont, is_first):
        i = self.ptr
        self.obs[i] = obs
        self.action[i] = action
        self.reward[i] = reward
        self.cont[i] = cont
        self.is_first[i] = is_first
        self.ptr = (i + 1) % self.capacity
        self.n = min(self.n + 1, self.capacity)

    def sample(self, rng, batch_size: int, length: int) -> dict:
        starts = rng.integers(0, self.n - length, size=batch_size)
        if self.n == self.capacity:
            # Wrapped ring: a linear window containing the write head
            # splices the newest transition onto the oldest with no
            # is_first at the joint — resample any window crossing it.
            for _ in range(8):
                bad = (starts < self.ptr) & (starts + length > self.ptr)
                if not bad.any():
                    break
                starts[bad] = rng.integers(0, self.n - length,
                                           size=int(bad.sum()))
            else:
                # Deterministic safe start: at ptr the window reads only
                # old data; if ptr is too near the end, 0 is clear of it.
                starts[bad] = self.ptr if self.ptr <= self.n - length else 0
        idx = starts[:, None] + np.arange(length)[None, :]
        return {
            "obs": self.obs[idx],
            "action": self.action[idx],
            "reward": self.reward[idx],
            "cont": self.cont[idx],
            "is_first": self.is_first[idx],
        }


def gumbel(shape: tuple, generator: torch.Generator,
           device) -> torch.Tensor:
    """Gumbel(0, 1) draws as jax.random.gumbel makes them from uniforms
    in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _label(key: str) -> str:
    return ("actor" if key.startswith("actor") else
            "critic" if key.startswith("critic") else "model")


class DreamerV3:
    """Algorithm driver (parity: Algorithm.train loop of the reference's
    dreamerv3/dreamerv3.py training_step: sample env → update world
    model + actor + critic from replayed sequences)."""

    def __init__(self, config: DreamerV3Config, device=None):
        self.device = resolve_device(device)
        self.config = config
        self.env = make_env(config.env)
        self.obs_size = self.env.observation_size
        self.num_actions = self.env.num_actions
        self.replay = _SeqReplay(config.replay_capacity, self.obs_size,
                                 self.num_actions)
        self.rng = np.random.default_rng(config.seed)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
        self.params = tensor_params(self._init_params(), self.device,
                                    trainable=True)
        self.optimizer = torch.optim.Adam(
            [{"params": [self.params[k][n] for k in self.params
                         if _label(k) == label for n in ("w", "b")],
              "lr": getattr(config, f"{label}_lr"), "label": label}
             for label in LABELS], betas=(0.9, 0.999), eps=1e-8)
        self.slow_critic = tree_copy({k: self.params[k]
                                      for k in ("critic1", "critic2")})
        # Percentile return normalization state (paper: S = EMA of
        # Per(R,95) - Per(R,5), advantages divided by max(1, S)).
        self.ret_scale = torch.tensor(1.0, device=self.device)
        # Filter state for the env loop, on the device.
        zdim = config.stoch_groups * config.stoch_classes
        self._h = torch.zeros(config.deter, device=self.device)
        self._z = torch.zeros(zdim, device=self.device)
        self._prev_action = 0
        self._obs = self.env.reset(seed=config.seed)
        self._is_first = 1.0
        self._ep_ret = 0.0
        self._episode_returns: list[float] = []
        self.iteration = 0
        self.total_env_steps = 0

    # ---------------- params ----------------

    def _init_params(self) -> dict:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        zdim = cfg.stoch_groups * cfg.stoch_classes
        na, h, d = self.num_actions, cfg.hidden, cfg.deter

        def dense(i, o, scale=1.0):
            return {"w": (rng.standard_normal((i, o)) * scale /
                          np.sqrt(i)).astype(np.float32),
                    "b": np.zeros(o, np.float32)}

        return {
            # encoder: symlog(obs) -> embedding
            "enc1": dense(self.obs_size, h),
            "enc2": dense(h, h),
            # GRU core: input [z, a_onehot] -> 3*deter gates
            "gru_x": dense(zdim + na, 3 * d),
            "gru_h": dense(d, 3 * d),
            # prior / posterior categorical logit heads
            "prior1": dense(d, h),
            "prior2": dense(h, zdim),
            "post1": dense(d + h, h),
            "post2": dense(h, zdim),
            # decoders ([h, z] features)
            "dec1": dense(d + zdim, h),
            "dec2": dense(h, self.obs_size),
            "rew1": dense(d + zdim, h),
            "rew2": dense(h, 1, scale=0.0),   # zero-init output head
            "cont1": dense(d + zdim, h),
            "cont2": dense(h, 1),
            # actor / critic (separate optimizers)
            "actor1": dense(d + zdim, h),
            "actor2": dense(h, na, scale=0.01),
            "critic1": dense(d + zdim, h),
            "critic2": dense(h, 1, scale=0.0),
        }

    def load_reference_state(self, params: dict, adam_states: dict,
                             slow_critic: dict, ret_scale) -> None:
        """Loads the reference's state mid-training: its params, the
        optax.multi_transform state as {label: (count, mu, nu)} with each
        label's moments over its own keys (one ScaleByAdamState per
        label), the slow critic and the return scale."""
        load_tree(self.params, params)
        for label, (count, mu, nu) in adam_states.items():
            load_adam_state(self.optimizer,
                            {k: self.params[k] for k in mu}, count, mu, nu)
        load_tree(self.slow_critic, slow_critic)
        self.ret_scale.fill_(float(ret_scale))

    # ---------------- model fns ----------------

    def _mlp2(self, p, k1: str, k2: str, x):
        h = F.silu(x @ p[k1]["w"] + p[k1]["b"])
        return h @ p[k2]["w"] + p[k2]["b"]

    def _gru(self, p, h, x):
        gates_x = x @ p["gru_x"]["w"] + p["gru_x"]["b"]
        gates_h = h @ p["gru_h"]["w"] + p["gru_h"]["b"]
        r_x, u_x, c_x = gates_x.chunk(3, dim=-1)
        r_h, u_h, c_h = gates_h.chunk(3, dim=-1)
        r = torch.sigmoid(r_x + r_h)
        u = torch.sigmoid(u_x + u_h)
        c = torch.tanh(c_x + r * c_h)
        return u * c + (1 - u) * h

    def _sample_latent(self, logits, noise):
        """Straight-through one-hot sample from G categorical groups,
        with 1% uniform mix (paper: 'unimix' keeps KL finite); `noise`
        the Gumbel draws of the categorical, shaped [..., G, C]."""
        G, C = self.config.stoch_groups, self.config.stoch_classes
        lg = logits.reshape(*logits.shape[:-1], G, C)
        probs = 0.99 * torch.softmax(lg, dim=-1) + 0.01 / C
        lg = torch.log(probs)
        idx = torch.argmax(noise + lg, dim=-1)
        onehot = F.one_hot(idx, C).to(probs.dtype)
        st = onehot + probs - probs.detach()
        return st.reshape(*st.shape[:-2], G * C), lg

    def _obs_step(self, p, h, z, action_onehot, emb, noise):
        """One filtering step: advance the sequence model, then fuse
        the observation embedding into the posterior."""
        h = self._gru(p, h, torch.cat([z, action_onehot], -1))
        prior_logits = self._mlp2(p, "prior1", "prior2", h)
        post_logits = self._mlp2(p, "post1", "post2",
                                 torch.cat([h, emb], -1))
        z, _ = self._sample_latent(post_logits, noise)
        return h, z, prior_logits, post_logits

    def _encode(self, p, obs):
        return self._mlp2(p, "enc1", "enc2", _symlog(obs))

    def _unimix_logp(self, logits):
        C = self.config.stoch_classes
        return torch.log_softmax(
            torch.log(0.99 * torch.softmax(logits, dim=-1) + 0.01 / C),
            dim=-1)

    @staticmethod
    def _kl_cat(lg_q, lg_p):
        """KL(q||p) summed over groups; inputs are log-prob tensors
        [..., G, C]."""
        q = torch.exp(lg_q)
        return (q * (lg_q - lg_p)).sum(-1).sum(-1)

    def _wm_loss(self, p, batch: dict, noise):
        """The world-model loss over [B, L] sequences, the filter
        unrolled over L; returns (loss, hs, zs, aux)."""
        cfg = self.config
        G, C = cfg.stoch_groups, cfg.stoch_classes
        B, L = batch["obs"].shape[:2]
        emb = self._encode(p, batch["obs"])            # [B, L, h]
        a_onehot = F.one_hot(batch["action"].long(),
                             self.num_actions).to(emb.dtype)
        h = torch.zeros(B, cfg.deter, device=emb.device)
        z = torch.zeros(B, G * C, device=emb.device)
        hs, zs, prior_lg, post_lg = [], [], [], []
        for t in range(L):
            # Episode starts reset the recurrent state and the previous
            # action (paper: is_first masking).
            first = batch["is_first"][:, t][:, None]
            h = h * (1 - first)
            z = z * (1 - first)
            act = a_onehot[:, t] * (1 - first)
            h, z, prior_logits, post_logits = self._obs_step(
                p, h, z, act, emb[:, t], noise[t])
            hs.append(h)
            zs.append(z)
            prior_lg.append(prior_logits)
            post_lg.append(post_logits)
        hs, zs = torch.stack(hs, 1), torch.stack(zs, 1)
        prior_lgp = self._unimix_logp(
            torch.stack(prior_lg, 1).reshape(B, L, G, C))
        post_lgp = self._unimix_logp(
            torch.stack(post_lg, 1).reshape(B, L, G, C))

        feat = torch.cat([hs, zs], -1)
        obs_pred = self._mlp2(p, "dec1", "dec2", feat)
        rew_pred = self._mlp2(p, "rew1", "rew2", feat)[..., 0]
        cont_logit = self._mlp2(p, "cont1", "cont2", feat)[..., 0]

        pred_loss = ((obs_pred - _symlog(batch["obs"])) ** 2).sum(-1) \
            + (rew_pred - _symlog(batch["reward"])) ** 2
        # Binary CE for the continue head.
        cont_ce = -(batch["cont"] * F.logsigmoid(cont_logit)
                    + (1 - batch["cont"]) * F.logsigmoid(-cont_logit))
        # KL balancing with free bits (paper eq. 5).
        dyn = torch.clamp(self._kl_cat(post_lgp.detach(), prior_lgp),
                          min=cfg.free_bits)
        rep = torch.clamp(self._kl_cat(post_lgp, prior_lgp.detach()),
                          min=cfg.free_bits)
        loss = (cfg.beta_pred * (pred_loss + cont_ce)
                + cfg.beta_dyn * dyn + cfg.beta_rep * rep).mean()
        return loss, hs.detach(), zs.detach(), {
            "wm_loss": loss, "kl_dyn": dyn.mean(),
            "recon": pred_loss.mean()}

    def _actor_logp(self, p, feat):
        return torch.log_softmax(self._mlp2(p, "actor1", "actor2", feat),
                                 dim=-1)

    def _critic_value(self, p, feat):
        return _symexp(self._mlp2(p, "critic1", "critic2", feat)[..., 0])

    def _lambda_returns(self, rew, cont, values, last_value):
        """Bootstrapped lambda-returns down the imagined horizon."""
        cfg = self.config
        rets, nxt = [None] * rew.shape[0], last_value
        for t in range(rew.shape[0] - 1, -1, -1):
            nxt = rew[t] + cfg.gamma * cont[t] * (
                (1 - cfg.lam) * values[t + 1] + cfg.lam * nxt)
            rets[t] = nxt
        return torch.stack(rets)

    def _imagine(self, hs, zs, noise: dict):
        """The H-step imagination from every filtered state, under the
        frozen world model (no graph): (feats [H, N, f], actions, the
        final feature)."""
        cfg = self.config
        p = self.params
        h = hs.reshape(-1, cfg.deter)
        z = zs.reshape(-1, zs.shape[-1])
        feats, acts = [], []
        for k in range(cfg.imag_horizon):
            feat = torch.cat([h, z], -1)
            a = torch.argmax(noise["act"][k] + self._actor_logp(p, feat),
                             dim=-1)
            h = self._gru(p, h, torch.cat(
                [z, F.one_hot(a, self.num_actions).to(h.dtype)], -1))
            prior_logits = self._mlp2(p, "prior1", "prior2", h)
            z, _ = self._sample_latent(prior_logits, noise["prior"][k])
            feats.append(feat)
            acts.append(a)
        return torch.stack(feats), torch.stack(acts), torch.cat([h, z], -1)

    def update(self, batch: dict, noise: dict) -> dict:
        """One fused update on replayed [B, L] sequences (numpy or
        tensors: obs, action, reward, cont, is_first) with the Gumbel
        noise {"post", "act", "prior"}: the world model, the actor and
        the critic each take one Adam step, the slow critic its EMA step
        and ret_scale its EMA. Returns the reference's aux terms as
        device tensors."""
        cfg = self.config
        p = self.params
        with device_context(self.device):
            b = device_batch(batch, self.device)
            noise = {k: torch.as_tensor(v).to(self.device)
                     for k, v in noise.items()}
            self.optimizer.zero_grad(set_to_none=True)
            wl, hs, zs, wm_aux = self._wm_loss(p, b, noise["post"])

            # ---- imagination under the frozen world model ----
            with torch.no_grad():
                feats, acts, featH = self._imagine(hs, zs, noise)
                rew = _symexp(self._mlp2(p, "rew1", "rew2", feats)[..., 0])
                cont = torch.sigmoid(
                    self._mlp2(p, "cont1", "cont2", feats)[..., 0])
                values = self._critic_value(p, feats)
                slow_values = self._critic_value(self.slow_critic, feats)
                last_v = self._critic_value(p, featH)
                rets = self._lambda_returns(
                    rew, cont, torch.cat([values, last_v[None]], 0), last_v)
                # Discount weights: product of continues down the horizon.
                disc = torch.cumprod(
                    torch.cat([torch.ones_like(cont[:1]), cont[:-1]], 0), 0)
                # Percentile normalization (paper): scale advantages by
                # max(1, EMA(Per95 - Per5)).
                flat = rets.reshape(-1)
                scale = torch.quantile(flat, 0.95) - torch.quantile(flat, 0.05)
                new_ret_scale = 0.99 * self.ret_scale + 0.01 * scale
                norm = torch.clamp(new_ret_scale, min=1.0)
                adv = (rets - values) / norm

            # ---- actor and critic, each into its own head ----
            lgp = self._actor_logp(p, feats)
            logp_a = take(lgp, acts)
            ent = -(torch.exp(lgp) * lgp).sum(-1)
            al = -(disc * (logp_a * adv + cfg.entropy_coeff * ent)).mean()
            v_pred = self._mlp2(p, "critic1", "critic2", feats)[..., 0]
            target = _symlog(rets)
            slow_t = _symlog(slow_values)
            cl = (disc * ((v_pred - target) ** 2
                          + 0.3 * (v_pred - slow_t) ** 2)).mean()

            (wl + al + cl).backward()
            self.optimizer.step()
            # EMA slow critic.
            d = cfg.critic_ema_decay
            with torch.no_grad():
                for hk in ("critic1", "critic2"):
                    for n in ("w", "b"):
                        s = self.slow_critic[hk][n]
                        s.copy_(d * s + (1 - d) * p[hk][n])
                self.ret_scale.copy_(new_ret_scale)
        return {**{k: v.detach() for k, v in wm_aux.items()},
                "actor_loss": al.detach(), "critic_loss": cl.detach(),
                "entropy": ent.mean().detach(), "imag_return": rets.mean()}

    def update_noise(self) -> dict:
        """An update's Gumbel draws from the learner's generator."""
        cfg = self.config
        G, C = cfg.stoch_groups, cfg.stoch_classes
        B, L, H = cfg.batch_size, cfg.batch_length, cfg.imag_horizon
        g, dev = self.generator, self.device
        return {"post": gumbel((L, B, G, C), g, dev),
                "act": gumbel((H, B * L, self.num_actions), g, dev),
                "prior": gumbel((H, B * L, G, C), g, dev)}

    def act(self, h, z, prev_action: int, obs, is_first: float,
            noise_post, noise_act):
        """One filter step on an observation and an action from the
        actor: (h, z, action tensor), on the device, no graph."""
        cfg = self.config
        p = self.params
        with torch.no_grad(), device_context(self.device):
            obs = torch.as_tensor(np.asarray(obs, np.float32)).to(
                self.device)
            emb = self._encode(p, obs[None])
            h = h[None] * (1 - is_first)
            z = z[None] * (1 - is_first)
            a_onehot = F.one_hot(
                torch.tensor([prev_action], device=self.device),
                self.num_actions).to(h.dtype) * (1 - is_first)
            h, z, _, _ = self._obs_step(p, h, z, a_onehot, emb,
                                        noise_post.reshape(
                                            1, cfg.stoch_groups,
                                            cfg.stoch_classes))
            feat = torch.cat([h, z], -1)
            a = torch.argmax(noise_act.reshape(1, -1)
                             + self._actor_logp(p, feat), dim=-1)[0]
        return h[0], z[0], a

    def _act_noise(self, n: int):
        cfg = self.config
        g, dev = self.generator, self.device
        return (gumbel((n, 1, cfg.stoch_groups, cfg.stoch_classes), g, dev),
                gumbel((n, 1, self.num_actions), g, dev))

    # ---------------- env loop + train ----------------

    def _env_steps(self, n: int):
        post, act = self._act_noise(n)
        for i in range(n):
            h, z, a = self.act(self._h, self._z, self._prev_action,
                               self._obs, self._is_first, post[i], act[i])
            a = int(a)
            next_obs, rew, done, info = self.env.step(a)
            truncated = bool(info.get("truncated", False))
            self.replay.add(self._obs, a, rew, 0.0 if (done and not truncated)
                            else 1.0, self._is_first)
            self._h, self._z = h, z
            self._prev_action = a
            self._is_first = 0.0
            self._ep_ret += rew
            self.total_env_steps += 1
            if done:
                self._episode_returns.append(self._ep_ret)
                self._ep_ret = 0.0
                self._obs = self.env.reset()
                self._is_first = 1.0
                self._prev_action = 0
            else:
                self._obs = next_obs

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        self._episode_returns = []
        self._env_steps(cfg.env_steps_per_iter)
        sample_time = time.time() - t0
        t1 = time.time()
        aux = {}
        updates_run = 0
        if self.replay.n > max(cfg.warmup_steps,
                               cfg.batch_length + 1):
            for _ in range(cfg.updates_per_iter):
                batch = self.replay.sample(self.rng, cfg.batch_size,
                                           cfg.batch_length)
                aux = self.update(batch, self.update_noise())
                updates_run += 1
        self.iteration += 1
        rets = self._episode_returns
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(rets)) if rets else
            float("nan"),
            "episodes_this_iter": len(rets),
            "timesteps_total": self.total_env_steps,
            "num_updates": updates_run,
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(time.time() - t1, 3),
            **{k: float(v) for k, v in aux.items()},
        }

    def compute_single_action(self, obs) -> int:
        """An action from a FRESH filter state (evaluation helper)."""
        post, act = self._act_noise(1)
        _, _, a = self.act(torch.zeros_like(self._h),
                           torch.zeros_like(self._z), 0, obs, 1.0,
                           post[0], act[0])
        return int(a)

    def stop(self):
        pass
