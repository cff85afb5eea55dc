"""DT: Decision Transformer — offline RL as sequence modeling. Port of
ray_tpu/rllib/dt.py.

Parity: reference rllib/algorithms/dt/ (return-conditioned behavior
cloning: a causal transformer over (return-to-go, state, action) token
triples predicts the next action; acting conditions on a target
return). Training is a transformer train step, no simulator in the
loop.

The transformer is the reference's own, written out in torch: token
embeddings per modality plus learned positions, pre-LN causal blocks
(LayerNorm by hand with a biased variance, rsqrt and eps 1e-5; the
causal softmax over the 3K interleaved tokens as einsums with the mask
filled by -1e30; tanh-form GELU, jax.nn.gelu's default). It reaches no
Pallas kernel in the reference, so it stays plain torch here, f32 on
the learner's device with torch Adam at optax.adam's defaults.
Episodes come from the same JSONL logs BC/MARWIL/CRR read, and the
batches are the reference's numpy draws.
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
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.ppo import adam, device_batch, tensor_params


@dataclass
class DTConfig:
    """Fluent config (parity: rllib DTConfig)."""

    env: Any = "CartPole-v1"
    input_path: str | None = None
    context_len: int = 8          # K timesteps => 3K tokens
    embed_dim: int = 64
    n_layers: int = 2
    n_heads: int = 2
    gamma: float = 1.0            # DT uses undiscounted returns-to-go
    lr: float = 1e-3
    train_batch_size: int = 64
    num_sgd_iter_per_train: int = 20
    target_return: float | None = None  # None: best return in the data
    seed: int = 0

    def environment(self, env):
        self.env = env
        return self

    def offline_data(self, input_path: str):
        self.input_path = input_path
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown DT option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "DT":
        """device: where the transformer runs; None means the card, and
        raises without one (before the data is read)."""
        return DT(self, device=device)


def layer_norm(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * g + b


def block(p: dict, x, n_heads: int):
    """One pre-LN causal block over (B, T, E) tokens."""
    B, T, E = x.shape
    hd = E // n_heads
    h = layer_norm(x, p["ln1_g"], p["ln1_b"])
    qkv = h @ p["qkv"]["w"] + p["qkv"]["b"]
    q, k, v = (t.reshape(B, T, n_heads, hd).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / float(np.sqrt(hd))
    mask = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, -1e30)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", a, v)
    o = o.transpose(1, 2).reshape(B, T, E)
    x = x + o @ p["proj"]["w"] + p["proj"]["b"]
    h = layer_norm(x, p["ln2_g"], p["ln2_b"])
    h = F.gelu(h @ p["mlp1"]["w"] + p["mlp1"]["b"], approximate="tanh")
    return x + h @ p["mlp2"]["w"] + p["mlp2"]["b"]


def forward(params: dict, rtg, obs, act_onehot, n_layers: int,
            n_heads: int):
    """Action logits (B, K, num_actions): the (rtg, obs, act) tokens
    interleaved at positions 3t..3t+2, action t predicted from the OBS
    token at 3t+1."""
    B, K = rtg.shape
    e_r = rtg[..., None] @ params["emb_rtg"]["w"] + params["emb_rtg"]["b"]
    e_o = obs @ params["emb_obs"]["w"] + params["emb_obs"]["b"]
    e_a = act_onehot @ params["emb_act"]["w"] + params["emb_act"]["b"]
    x = torch.stack([e_r, e_o, e_a], dim=2).reshape(B, 3 * K, -1)
    x = x + params["pos"][None]
    for li in range(n_layers):
        x = block(params[f"blk{li}"], x, n_heads)
    return x[:, 1::3] @ params["head"]["w"] + params["head"]["b"]


class DT:
    def __init__(self, config: DTConfig, device=None):
        self.device = resolve_device(device)
        self.config = config
        probe = make_env(config.env)
        self.obs_size = probe.observation_size
        self.num_actions = probe.num_actions
        self.episodes = self._load_episodes()
        self.max_return = max(ep["rtg"][0] for ep in self.episodes)
        self.params = tensor_params(self._init_params(), self.device,
                                    trainable=True)
        self.optimizer = adam(self.params, config.lr)
        self.iteration = 0

    # ---- data ----

    def _load_episodes(self) -> list:
        cfg = self.config
        if cfg.input_path is None:
            raise ValueError("DT needs offline_data(input_path=...)")
        d = JsonReader(cfg.input_path).read_all()
        obs, acts = d["obs"], d["actions"]
        rews, dones = d["rewards"], d["dones"]
        episodes, start = [], 0
        for t in range(len(obs)):
            if dones[t] or t == len(obs) - 1:
                ep_r = rews[start:t + 1]
                # (Discounted) return-to-go; DT's canonical setting is
                # gamma=1 but the knob is honored.
                rtg = np.zeros(len(ep_r), np.float32)
                acc = 0.0
                for i in range(len(ep_r) - 1, -1, -1):
                    acc = ep_r[i] + cfg.gamma * acc
                    rtg[i] = acc
                episodes.append({"obs": obs[start:t + 1],
                                 "actions": acts[start:t + 1],
                                 "rtg": rtg})
                start = t + 1
        return [e for e in episodes if len(e["obs"]) > 0]

    # ---- model ----

    def _init_params(self) -> dict:
        cfg = self.config
        rng = np.random.default_rng(cfg.seed)
        E, K = cfg.embed_dim, cfg.context_len

        def dense(i, o):
            return {"w": (rng.standard_normal((i, o)) *
                          (1.0 / np.sqrt(i))).astype(np.float32),
                    "b": np.zeros(o, np.float32)}

        p = {
            "emb_rtg": dense(1, E),
            "emb_obs": dense(self.obs_size, E),
            "emb_act": dense(self.num_actions, E),  # one-hot actions
            "pos": (rng.standard_normal((3 * K, E)) * 0.02
                    ).astype(np.float32),
            "head": dense(E, self.num_actions),
        }
        for li in range(cfg.n_layers):
            p[f"blk{li}"] = {
                "ln1_g": np.ones(E, np.float32),
                "ln1_b": np.zeros(E, np.float32),
                "qkv": dense(E, 3 * E),
                "proj": dense(E, E),
                "ln2_g": np.ones(E, np.float32),
                "ln2_b": np.zeros(E, np.float32),
                "mlp1": dense(E, 4 * E),
                "mlp2": dense(4 * E, E),
            }
        return p

    def _forward(self, params, rtg, obs, act_onehot):
        cfg = self.config
        return forward(params, rtg, obs, act_onehot, cfg.n_layers,
                       cfg.n_heads)

    def logits(self, rtg, obs, act_onehot) -> np.ndarray:
        """The forward on the learner's device for numpy contexts; the
        logits come back as numpy."""
        with torch.no_grad(), device_context(self.device):
            b = device_batch({"rtg": rtg, "obs": obs, "onehot": act_onehot},
                             self.device)
            return self._forward(self.params, b["rtg"], b["obs"],
                                 b["onehot"]).cpu().numpy()

    def update(self, rtg, obs, act_onehot, actions, mask):
        """One Adam step on a batch (the five arrays _sample_batch gives,
        numpy or tensors); returns the masked NLL as a device tensor."""
        with device_context(self.device):
            b = device_batch({"rtg": rtg, "obs": obs, "onehot": act_onehot,
                              "actions": actions, "mask": mask}, self.device)
            self.optimizer.zero_grad(set_to_none=True)
            logits = self._forward(self.params, b["rtg"], b["obs"],
                                   b["onehot"])
            nll = -take(torch.log_softmax(logits, dim=-1), b["actions"])
            loss = (nll * b["mask"]).sum() \
                / torch.clamp(b["mask"].sum(), min=1.0)
            loss.backward()
            self.optimizer.step()
        return loss.detach()

    def _sample_batch(self, rng):
        cfg = self.config
        K = cfg.context_len
        B = cfg.train_batch_size
        rtg = np.zeros((B, K), np.float32)
        obs = np.zeros((B, K, self.obs_size), np.float32)
        act = np.zeros((B, K), np.int32)
        mask = np.zeros((B, K), np.float32)
        for i in range(B):
            ep = self.episodes[rng.integers(len(self.episodes))]
            L = len(ep["obs"])
            start = rng.integers(max(1, L - K + 1))
            n = min(K, L - start)
            rtg[i, :n] = ep["rtg"][start:start + n]
            obs[i, :n] = ep["obs"][start:start + n]
            act[i, :n] = ep["actions"][start:start + n]
            mask[i, :n] = 1.0
        onehot = np.eye(self.num_actions, dtype=np.float32)[act]
        # Action token t must not leak action t into its own prediction:
        # the causal mask handles it (action token sits AFTER the obs
        # token the prediction reads from).
        return rtg, obs, onehot, act, mask

    def train(self) -> dict:
        cfg = self.config
        t0 = time.time()
        rng = np.random.default_rng(cfg.seed + self.iteration)
        losses = [self.update(*self._sample_batch(rng))
                  for _ in range(cfg.num_sgd_iter_per_train)]
        self.iteration += 1
        return {
            "training_iteration": self.iteration,
            "loss": float(np.mean(torch.stack(losses).cpu().numpy()
                                  .astype(np.float64))),
            "num_samples_trained": cfg.num_sgd_iter_per_train
            * cfg.train_batch_size,
            "episodes_in_dataset": len(self.episodes),
            "max_dataset_return": float(self.max_return),
            "iter_time_s": round(time.time() - t0, 3),
        }

    def evaluate(self, episodes: int = 4,
                 target_return: float | None = None,
                 max_steps: int = 200) -> dict:
        """Roll out conditioning on the target return (DT's whole point:
        aim for a return, act accordingly)."""
        cfg = self.config
        K = cfg.context_len
        env = make_env(cfg.env)
        target = (target_return if target_return is not None
                  else cfg.target_return
                  if cfg.target_return is not None else self.max_return)
        totals = []
        for ep in range(episodes):
            obs_hist, act_hist, rtg_hist = [], [], []
            o = env.reset(seed=cfg.seed + 100 + ep)
            rtg = float(target)
            total = 0.0
            for _t in range(max_steps):
                obs_hist.append(np.asarray(o, np.float32))
                rtg_hist.append(rtg)
                act_hist.append(0)   # placeholder for the current step
                rtgs = np.zeros((1, K), np.float32)
                obss = np.zeros((1, K, self.obs_size), np.float32)
                acts = np.zeros((1, K), np.int32)
                n = min(K, len(obs_hist))
                rtgs[0, :n] = rtg_hist[-n:]
                obss[0, :n] = obs_hist[-n:]
                acts[0, :n] = act_hist[-n:]
                onehot = np.eye(self.num_actions, dtype=np.float32)[acts]
                logits = self.logits(rtgs, obss, onehot)
                a = int(np.argmax(logits[0, n - 1]))
                act_hist[-1] = a
                o, r, done, _ = env.step(a)
                total += r
                rtg -= r
                if done:
                    break
            totals.append(total)
        return {"episode_reward_mean": float(np.mean(totals)),
                "target_return": float(target)}

    def compute_single_action(self, obs) -> int:
        cfg = self.config
        K = cfg.context_len
        rtgs = np.zeros((1, K), np.float32)
        rtgs[0, 0] = self.max_return
        obss = np.zeros((1, K, self.obs_size), np.float32)
        obss[0, 0] = obs
        acts = np.zeros((1, K), np.int32)
        onehot = np.eye(self.num_actions, dtype=np.float32)[acts]
        return int(np.argmax(self.logits(rtgs, obss, onehot)[0, 0]))

    def stop(self):
        pass
