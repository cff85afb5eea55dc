"""SlateQ: Q-learning over recommendation slates via itemwise
decomposition. Port of ray_tpu/rllib/slateq.py.

Parity: reference rllib/algorithms/slateq/ (RecSim-style environment;
the SlateQ decomposition Q(s, A) = sum_{i in A} P(i | s, A) q(s, i)
with a known conditional-choice model; itemwise q trained by SARSA-style
TD on the CLICKED item; greedy slate building by choice-weighted
top-k). `SlateQLearner` computes the itemwise q over all candidates as
one batched update on the card. Ships SlateDocEnv, the synthetic
user/document simulator standing in for RecSim interest-evolution.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.ppo import TorchLearner, stop_actors
from ray_tpu_torch.rllib.utils import CPUActor, tree_assign, tree_copy


class SlateDocEnv:
    """Synthetic recommender: a user interest vector over `dim` topics,
    `num_docs` fixed documents with topic features. Each step the agent
    shows a slate of `slate_size` docs; the user clicks doc i with
    P ∝ exp(interest·doc_i) against a no-click alternative, engagement
    reward = sigmoid(interest·doc) of the click, and interests drift
    toward clicked topics (interest evolution). Horizon fixed."""

    dim = 6
    num_docs = 20
    slate_size = 3
    horizon = 20
    no_click_mass = 1.0

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.docs = rng.standard_normal(
            (self.num_docs, self.dim)).astype(np.float32)
        self.docs /= np.linalg.norm(self.docs, axis=1, keepdims=True)
        self.rng = rng

    @property
    def observation_size(self) -> int:
        return self.dim

    def reset(self, seed: int | None = None) -> np.ndarray:
        if seed is not None:
            self.rng = np.random.default_rng(seed)
        self.user = self.rng.standard_normal(self.dim).astype(np.float32)
        self.user /= np.linalg.norm(self.user)
        self.t = 0
        return self.user.copy()

    def choice_probs(self, slate: np.ndarray) -> np.ndarray:
        """P(click each slate item) + trailing P(no click) — the known
        conditional choice model SlateQ assumes."""
        scores = np.exp(self.docs[slate] @ self.user)
        denom = scores.sum() + self.no_click_mass
        return np.concatenate([scores / denom,
                               [self.no_click_mass / denom]])

    def step(self, slate: np.ndarray):
        probs = self.choice_probs(slate)
        pick = int(self.rng.choice(len(probs), p=probs))
        reward = 0.0
        clicked = -1
        if pick < len(slate):
            clicked = int(slate[pick])
            affinity = float(self.docs[clicked] @ self.user)
            reward = 1.0 / (1.0 + np.exp(-affinity))
            # Interest evolution: drift toward the clicked topic.
            self.user = 0.9 * self.user + 0.1 * self.docs[clicked]
            self.user /= np.linalg.norm(self.user)
        self.t += 1
        return self.user.copy(), reward, self.t >= self.horizon, \
            {"clicked": clicked}


def init_slateq_params(dim: int, hidden: int = 64, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o))
                      / np.sqrt(i)).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    # Itemwise q(s, d): input [user ; doc] -> scalar.
    return {"h1": dense(2 * dim, hidden), "h2": dense(hidden, hidden),
            "q": dense(hidden, 1)}


def numpy_item_q(params: dict, user: np.ndarray,
                 docs: np.ndarray) -> np.ndarray:
    """q(s, d) for every candidate doc: [D]."""
    x = np.concatenate(
        [np.repeat(user[None, :], len(docs), 0), docs], axis=1)
    h = np.tanh(x @ params["h1"]["w"] + params["h1"]["b"])
    h = np.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    return (h @ params["q"]["w"] + params["q"]["b"])[:, 0]


def greedy_slate(params: dict, user: np.ndarray, docs: np.ndarray,
                 slate_size: int) -> np.ndarray:
    """SlateQ's greedy construction: rank docs by choice-model score
    times itemwise q (the top-k approximation of the fractional LP the
    paper shows is optimal for this choice model)."""
    v = np.exp(docs @ user)
    q = numpy_item_q(params, user, docs)
    return np.argsort(-(v * q))[:slate_size].astype(np.int64)


def slate_value(params: dict, user: np.ndarray, docs: np.ndarray,
                slate: np.ndarray, no_click_mass: float) -> float:
    """Decomposed Q(s, A) = sum_i P(i|s,A) q(s,i)."""
    scores = np.exp(docs[slate] @ user)
    denom = scores.sum() + no_click_mass
    q = numpy_item_q(params, user, docs[slate])
    return float((scores / denom) @ q)


def item_q(params, users, doc_feats):
    """numpy_item_q on tensors, one (user, doc) pair a row."""
    x = torch.cat([users, doc_feats], dim=1)
    h = torch.tanh(x @ params["h1"]["w"] + params["h1"]["b"])
    h = torch.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    return (h @ params["q"]["w"] + params["q"]["b"])[:, 0]


@ray_tpu_torch.remote(num_cpus=1)
class SlateQRolloutWorker(CPUActor):
    """CPU sampler: epsilon-greedy over slates (random slate vs greedy
    choice-weighted top-k)."""

    def __init__(self, worker_index: int, env_seed: int):
        super().__init__()
        self.env = SlateDocEnv(env_seed)
        self.rng = np.random.default_rng(7000 + worker_index)
        self.user = self.env.reset(seed=worker_index)
        self.ep_ret = 0.0

    def sample(self, params: dict, num_steps: int, epsilon: float) -> dict:
        env = self.env
        buf = {"user": [], "slate": [], "clicked": [], "reward": [],
               "next_user": [], "done": []}
        episode_returns = []
        for _ in range(num_steps):
            if self.rng.random() < epsilon:
                slate = self.rng.choice(env.num_docs, env.slate_size,
                                        replace=False).astype(np.int64)
            else:
                slate = greedy_slate(params, self.user, env.docs,
                                     env.slate_size)
            next_user, reward, done, info = env.step(slate)
            buf["user"].append(self.user)
            buf["slate"].append(slate)
            buf["clicked"].append(info["clicked"])
            buf["reward"].append(reward)
            buf["next_user"].append(next_user)
            buf["done"].append(float(done))
            self.ep_ret += reward
            if done:
                episode_returns.append(self.ep_ret)
                self.ep_ret = 0.0
                self.user = env.reset()
            else:
                self.user = next_user
        return {"user": np.asarray(buf["user"], np.float32),
                "slate": np.asarray(buf["slate"], np.int64),
                "clicked": np.asarray(buf["clicked"], np.int64),
                "reward": np.asarray(buf["reward"], np.float32),
                "next_user": np.asarray(buf["next_user"], np.float32),
                "done": np.asarray(buf["done"], np.float32),
                "episode_returns": episode_returns}


@dataclass
class SlateQConfig:
    """Parity: rllib SlateQConfig."""

    num_rollout_workers: int = 2
    rollout_fragment_length: int = 200
    buffer_capacity: int = 50_000
    train_batch_size: int = 128
    num_sgd_iter: int = 16
    gamma: float = 0.95
    lr: float = 1e-3
    hidden_size: int = 64
    target_network_update_freq: int = 4
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_iters: int = 12
    env_seed: int = 0
    seed: int = 0

    def rollouts(self, num_rollout_workers: int | None = None, **kw):
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown SlateQ option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "SlateQ":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return SlateQ(self, device=device)


class SlateQLearner(TorchLearner):
    """SlateQ's learner on one device: the itemwise q network and its
    target, one Adam step an update of the squared TD error of q(s,
    clicked doc) against r + gamma Q(s', greedy slate), the bootstrap
    slate built and valued by the target net over every candidate."""

    def __init__(self, config: SlateQConfig, docs: np.ndarray,
                 slate_size: int, no_click_mass: float, *,
                 params: dict | None = None, device=None):
        self.config = config
        if params is None:
            params = init_slateq_params(docs.shape[1], config.hidden_size,
                                        config.seed)
        super().__init__(params, self._loss, config.lr, device)
        self.target = tree_copy(self.params)
        self.docs = torch.as_tensor(docs, device=self.device)  # [D, dim]
        self.slate_size = slate_size
        self.no_click = no_click_mass

    def _next_slate_value(self, next_users):
        """Greedy choice-weighted slate + decomposed Q(s', A') — the
        SlateQ bootstrap, recomputed at train time with the current
        target net (stored scalars would anchor old entries to init-era
        targets)."""
        B, D = next_users.shape[0], self.docs.shape[0]
        v = torch.exp(next_users @ self.docs.T)                 # [B, D]
        q = item_q(self.target, torch.repeat_interleave(next_users, D, 0),
                   self.docs.repeat(B, 1)).reshape(B, D)       # [B, D]
        top = torch.topk(v * q, self.slate_size, dim=1).indices  # [B, k]
        v_sel = v.gather(1, top)
        q_sel = q.gather(1, top)
        denom = v_sel.sum(dim=1, keepdim=True) + self.no_click
        return (v_sel / denom * q_sel).sum(dim=1)

    def _loss(self, params, batch):
        q = item_q(params, batch["user"], batch["clicked_doc"])
        with torch.no_grad():
            target = batch["reward"] + self.config.gamma * \
                (1.0 - batch["done"]) * \
                self._next_slate_value(batch["next_user"])
        return torch.mean((q - target) ** 2), {}

    def sync_target(self) -> None:
        tree_assign(self.target, self.params)


class SlateQ:
    """Algorithm driver (parity: Algorithm.step / SlateQ
    training_step): the itemwise q is trained SARSA-style on clicked
    transitions toward r + gamma * Q(s', greedy slate), with Q'
    decomposed through the known choice model. The learner is made
    before the rollout workers."""

    def __init__(self, config: SlateQConfig, device=None):
        self.config = config
        self.env = SlateDocEnv(config.env_seed)  # doc catalog (fixed)
        dim = self.env.dim
        self.learner = SlateQLearner(config, self.env.docs,
                                     self.env.slate_size,
                                     self.env.no_click_mass, device=device)
        cap = config.buffer_capacity
        self.buf = {
            "user": np.zeros((cap, dim), np.float32),
            "clicked_doc": np.zeros((cap, dim), np.float32),
            "reward": np.zeros(cap, np.float32),
            "next_user": np.zeros((cap, dim), np.float32),
            "done": np.zeros(cap, np.float32),
        }
        self.pos = 0
        self.size = 0
        self.rng = np.random.default_rng(config.seed)
        self.workers = [
            SlateQRolloutWorker.remote(i, config.env_seed)
            for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_steps = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_initial + frac * (cfg.epsilon_final
                                             - cfg.epsilon_initial)

    def _ingest(self, out: dict) -> None:
        """Clicked transitions only (SlateQ's SARSA decomposition trains
        q(s, clicked); no-click steps carry no itemwise target). Only
        raw (s, clicked doc, r, s') is stored — the bootstrap slate
        value is recomputed inside the update with the CURRENT target
        net, so replayed entries never carry stale targets."""
        cfg = self.config
        mask = out["clicked"] >= 0
        users = out["user"][mask]
        clicked = out["clicked"][mask]
        n = len(users)
        if n == 0:
            return
        cap = cfg.buffer_capacity
        idx = (self.pos + np.arange(n)) % cap
        self.buf["user"][idx] = users
        self.buf["clicked_doc"][idx] = self.env.docs[clicked]
        self.buf["reward"][idx] = out["reward"][mask]
        self.buf["next_user"][idx] = out["next_user"][mask]
        self.buf["done"][idx] = out["done"][mask]
        self.pos = int((self.pos + n) % cap)
        self.size = int(min(self.size + n, cap))

    def train(self) -> dict:
        cfg = self.config
        eps = self._epsilon()
        rollout_params = self.learner.get_params()
        outs = ray_tpu_torch.get([
            w.sample.remote(rollout_params, cfg.rollout_fragment_length,
                            eps) for w in self.workers])
        returns = []
        for out in outs:
            self._ingest(out)
            returns += out["episode_returns"]
            self.total_steps += len(out["user"])
        losses = []
        if self.size >= cfg.train_batch_size:
            for _ in range(cfg.num_sgd_iter):
                idx = self.rng.integers(0, self.size,
                                        cfg.train_batch_size)
                batch = {k: v[idx] for k, v in self.buf.items()}
                loss, _aux = self.learner.update(batch)
                losses.append(loss)
        self.iteration += 1
        if self.iteration % cfg.target_network_update_freq == 0:
            self.learner.sync_target()
        return {"training_iteration": self.iteration,
                "episode_reward_mean":
                    float(np.mean(returns)) if returns else float("nan"),
                "num_env_steps_sampled": self.total_steps,
                "loss": float(np.mean(torch.stack(losses).tolist()))
                if losses else None}

    def stop(self):
        stop_actors(self.workers)

    def get_policy_params(self) -> dict:
        return self.learner.get_params()
