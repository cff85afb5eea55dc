"""PPO: CPU rollout actors and a learner on the card. Port of
ray_tpu/rllib/ppo.py.

Parity: reference rllib/algorithms/ppo/ + the rollout/learner split of
SURVEY.md §3.6: `RolloutWorker`s sample on CPU actors of the port's
runtime, and the learner takes minibatch SGD epochs on the device.
`PPOLearner` is that learner in the driver: the policy's params as f32
tensors, `torch.optim.Adam` (the defaults of optax.adam), `update` one
minibatch step and `learn` the SGD epochs of `PPO.train`. With
`num_learners > 1` the updates go to a `LearnerGroup` of GPU-leased
learner actors instead (learner_group.py).

Rollout workers run the MLP's numpy forward (a copy of the reference's,
so its samples are bitwise the reference's); image models run the
catalog's torch forward on the worker's CPU under no_grad, where the
reference jits its JAX forward on the CPU. A worker holds no card and
never initialises CUDA.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.rllib.catalog import get_model
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.utils import (ROLLOUT_THREADS,  # noqa: F401
                                       CPUActor, leaves, tree_numpy)


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


@ray_tpu_torch.remote(num_cpus=1)
class RolloutWorker(CPUActor):
    """CPU sampling actor (parity: rllib/evaluation/rollout_worker.py).

    model="mlp" uses the catalog's numpy forward; other models (the CNN)
    run the catalog's torch forward on this worker's CPU under no_grad,
    the params made tensors once a call. The worker holds one CPU and no
    card, and its torch runs ROLLOUT_THREADS threads."""

    def __init__(self, env_spec, worker_index: int, gamma: float, lam: float,
                 model: str = "mlp"):
        super().__init__()
        self.env = make_env(env_spec)
        self.index = worker_index
        self.gamma = gamma
        self.lam = lam
        self.rng = np.random.default_rng(1000 + worker_index)
        self.obs = self.env.reset(seed=worker_index)
        self._spec = get_model(model)
        self._torch = model != "mlp"

    def _policy(self, params):
        """obs -> (logits, value) as numpy, for one params tree."""
        if not self._torch:
            return lambda obs: self._spec.numpy_forward(params, obs)
        tparams = tensor_params(params, "cpu")

        def forward(obs):
            with torch.no_grad():
                logits, value = self._spec.torch_forward(
                    tparams, torch.from_numpy(np.ascontiguousarray(obs)))
            return logits.numpy(), value.numpy()

        return forward

    def sample_multi_agent(self, policy_params: dict, num_steps: int,
                           mapping: dict) -> dict:
        """Multi-agent fragment (parity: reference MultiAgentEnv sampling):
        steps every live agent with its mapped policy; returns one batch
        PER POLICY plus episode stats."""
        env = self.env
        if not isinstance(self.obs, dict):
            self.obs = env.reset(seed=self.index)
        policies = {pid: self._policy(p) for pid, p in policy_params.items()}
        bufs = {a: {k: [] for k in
                    ("obs", "actions", "logp", "rew", "val", "done")}
                for a in env.agent_ids}
        episode_returns = []
        ep_ret = 0.0
        for _ in range(num_steps):
            actions = {}
            for a, ob in self.obs.items():
                logits, value = policies[mapping[a]](np.asarray(ob)[None])
                logits = logits[0]
                pr = np.exp(logits - logits.max())
                pr /= pr.sum()
                act = int(self.rng.choice(len(pr), p=pr))
                actions[a] = act
                b = bufs[a]
                b["obs"].append(np.asarray(ob, np.float32))
                b["actions"].append(act)
                b["logp"].append(float(np.log(pr[act] + 1e-8)))
                b["val"].append(float(value[0]))
            next_obs, rews, dones, _ = env.step(actions)
            for a in actions:
                bufs[a]["rew"].append(float(rews.get(a, 0.0)))
                bufs[a]["done"].append(bool(dones.get(a, False)))
                ep_ret += float(rews.get(a, 0.0))
            if dones.get("__all__"):
                episode_returns.append(ep_ret)
                ep_ret = 0.0
                self.obs = env.reset()
            else:
                # Agents that just finished deliver their terminal obs with
                # done=True and then leave the episode: keep only live
                # agents, or the next loop would record a phantom
                # transition from a terminal state.
                self.obs = {a: o for a, o in next_obs.items()
                            if not dones.get(a, False)}
        out = {}
        for a, b in bufs.items():
            if not b["obs"]:
                continue
            # Bootstrap with the policy's value of the agent's last obs
            # (0 when the agent is already done).
            if a in self.obs and not (b["done"] and b["done"][-1]):
                _, lv = policies[mapping[a]](np.asarray(self.obs[a])[None])
                last_val = float(lv[0])
            else:
                last_val = 0.0
            vals = np.asarray(b["val"] + [last_val], np.float32)
            adv, rets = _gae(np.asarray(b["rew"], np.float32), vals,
                             np.asarray(b["done"], bool), self.gamma,
                             self.lam)
            pid = mapping[a]
            batch = {
                "obs": np.asarray(b["obs"], np.float32),
                "actions": np.asarray(b["actions"], np.int32),
                "logp": np.asarray(b["logp"], np.float32),
                "advantages": adv,
                "returns": rets,
            }
            if pid in out:
                out[pid] = {k: np.concatenate([out[pid][k], batch[k]])
                            for k in batch}
            else:
                out[pid] = batch
        return {"policy_batches": out, "episode_returns": episode_returns}

    def sample(self, params: dict, num_steps: int) -> dict:
        forward = self._policy(params)
        obs_buf, act_buf, logp_buf, rew_buf, val_buf, done_buf = \
            [], [], [], [], [], []
        episode_returns = []
        ep_ret = 0.0
        for _ in range(num_steps):
            logits, value = forward(np.asarray(self.obs)[None])
            logits = logits[0]
            p = np.exp(logits - logits.max())
            p /= p.sum()
            action = int(self.rng.choice(len(p), p=p))
            logp = float(np.log(p[action] + 1e-8))
            next_obs, reward, done, _ = self.env.step(action)
            obs_buf.append(self.obs)
            act_buf.append(action)
            logp_buf.append(logp)
            rew_buf.append(reward)
            val_buf.append(float(value[0]))
            done_buf.append(done)
            ep_ret += reward
            if done:
                episode_returns.append(ep_ret)
                ep_ret = 0.0
                self.obs = self.env.reset()
            else:
                self.obs = next_obs
        # Bootstrap value for the final partial episode.
        _, last_val = forward(np.asarray(self.obs)[None])
        vals = np.array(val_buf + [float(last_val[0])], np.float32)
        adv, returns = _gae(np.array(rew_buf, np.float32), vals,
                            np.array(done_buf, bool), self.gamma, self.lam)
        return {
            "obs": np.asarray(obs_buf, np.float32),
            "actions": np.asarray(act_buf, np.int32),
            "logp": np.asarray(logp_buf, np.float32),
            "advantages": adv,
            "returns": returns,
            "episode_returns": episode_returns,
        }


@dataclass
class PPOConfig:
    """Parity: rllib AlgorithmConfig/PPOConfig fluent-config object."""

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
    # allreduced gradients (reference: learner_group.py remote learners
    # + DDP sync); 1 = the learner in the driver.
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

    def build(self, device=None) -> "PPO":
        """device: where the learners run; None means the card, and
        raises without one."""
        return PPO(self, device=device)


def make_ppo_loss(forward, clip_param: float, vf_coeff: float,
                  entropy_coeff: float):
    """The PPO clipped-surrogate loss as a free function, so the learner
    in the driver and the LearnerGroup's learner actors run the same math
    (reference: Learner.compute_loss, rllib/core/learner/learner.py):
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


def tensor_params(params, device, trainable: bool = False):
    """A tree (dicts and lists) of numpy arrays (params, or Adam's
    moments) as f32 tensors on `device`."""
    if isinstance(params, dict):
        return {k: tensor_params(v, device, trainable)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [tensor_params(v, device, trainable) for v in params]
    return torch.tensor(np.asarray(params, np.float32), device=device,
                        requires_grad=trainable)


# A params tree of tensors as numpy arrays (for the numpy forward), copied.
numpy_params = tree_numpy


def sorted_items(tree, prefix: tuple = ()) -> list:
    """(path, leaf) pairs in sorted-key order at every dict and index
    order in every list: the order of jax.tree_util.tree_leaves over the
    reference's trees."""
    keys = sorted(tree) if isinstance(tree, dict) else range(len(tree))
    out = []
    for k in keys:
        v = tree[k]
        out.extend(sorted_items(v, prefix + (k,))
                   if isinstance(v, (dict, list, tuple))
                   else [(prefix + (k,), v)])
    return out


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


def adam(params, lr: float) -> torch.optim.Adam:
    """torch Adam with optax.adam's defaults over a tree's tensors."""
    return torch.optim.Adam(leaves(params), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def adam_state(learner) -> dict:
    """A learner's Adam state as the reference's optax state holds it:
    {"count": steps taken, "mu": first moments, "nu": second moments},
    the moments numpy trees shaped like the params."""
    count, mu, nu = 0, {}, {}
    for path, t in sorted_items(learner.params):
        st = learner.optimizer.state.get(t, {})
        for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = st[key].detach().cpu().numpy() if st else \
                np.zeros(tuple(t.shape), np.float32)
        if st:
            count = int(st["step"])
    return {"count": count, "mu": mu, "nu": nu}


def load_tree(tree, values) -> None:
    """Copies a numpy tree into the same-shaped tree of tensors, in
    place."""
    with torch.no_grad():
        for path, t in sorted_items(tree):
            t.copy_(torch.tensor(np.asarray(_at(values, path), np.float32)))


def load_adam_state(optimizer, tree, count: int, mu, nu) -> None:
    """optax's Adam state (count, mu, nu: its ScaleByAdamState, as numpy)
    as torch Adam's state of `tree`'s tensors: the moments become exp_avg
    and exp_avg_sq, count the step. `tree` may be a part of the tree the
    moments were taken over (the critics of an actor-critic tree, say):
    each of its leaves takes the moments at its own path."""
    for path, t in sorted_items(tree):
        optimizer.state[t] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.tensor(np.asarray(_at(mu, path), np.float32),
                                    device=t.device),
            "exp_avg_sq": torch.tensor(np.asarray(_at(nu, path),
                                                  np.float32),
                                       device=t.device)}


def load_reference_state(learner, params, count: int, mu, nu, *,
                         target=None) -> None:
    """Loads the reference learner's state into a port learner: its params
    and its optax Adam state, so both sides go on from one state
    mid-training; with `target`, the target network's params too (the
    learner's `target` tree). A learner with a second optimizer (SAC's
    temperature, MADDPG's actors, CRR's critic) takes that one's state
    through load_adam_state."""
    load_tree(learner.params, params)
    load_adam_state(learner.optimizer, learner.params, count, mu, nu)
    if target is not None:
        load_tree(learner.target, target)


def fill_grads(params) -> None:
    """Gives every tensor of the tree without a gradient a zero one: optax
    steps every leaf of its tree, a zero gradient decaying its moments,
    where torch's Adam skips a parameter whose .grad is None."""
    for t in leaves(params):
        if t.grad is None:
            t.grad = torch.zeros_like(t)


def device_batch(batch: dict, device) -> dict:
    """A batch of numpy arrays (or tensors) as tensors on `device`. An
    array the object store handed out read-only is copied first."""
    return {k: torch.as_tensor(v.copy() if isinstance(v, np.ndarray)
                               and not v.flags.writeable else v).to(device)
            for k, v in batch.items()}


class TorchLearner:
    """The device half every on-policy algorithm here shares (the
    reference's jitted value_and_grad + optax.adam update): a params tree
    as f32 tensors on one device, torch Adam with optax.adam's defaults,
    one step an update of loss_fn(params, batch) -> (total, aux).
    device: None means CUDA and raises without a card."""

    def __init__(self, params: dict, loss_fn, lr: float, device=None):
        self.device = resolve_device(device)
        self.params = tensor_params(params, self.device, trainable=True)
        self.optimizer = adam(self.params, lr)
        self._loss_fn = loss_fn
        self.updates = 0

    def _batch(self, batch: dict) -> dict:
        return device_batch(batch, self.device)

    def update(self, minibatch: dict):
        """One Adam step on the minibatch (numpy arrays or tensors).
        Returns the loss and the aux terms as device tensors; the grads
        stay in the params' .grad until the next update."""
        with device_context(self.device):
            batch = self._batch(minibatch)
            self.optimizer.zero_grad(set_to_none=True)
            loss, aux = self._loss_fn(self.params, batch)
            loss.backward()
            self.optimizer.step()
        self.updates += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def get_params(self) -> dict:
        """The params as numpy arrays, for the numpy forward."""
        return numpy_params(self.params)


class PPOLearner(TorchLearner):
    """The learner half of PPO on one device.

    obs_in: the observation size (an int), or for "atari_cnn" the
    observation shape (H, W, C). params: a numpy params tree (the
    catalog's init from config.seed when None). device: None means CUDA
    and raises without a card."""

    def __init__(self, config: PPOConfig, obs_in, num_actions: int, *,
                 params: dict | None = None, device=None):
        self.config = config
        spec = get_model(config.model)
        hidden = config.hidden_size or spec.default_hidden
        if params is None:
            params = spec.init_params(obs_in, num_actions, hidden,
                                      config.seed)
        super().__init__(params, make_ppo_loss(
            spec.torch_forward, config.clip_param, config.vf_coeff,
            config.entropy_coeff), config.lr, device)

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


def _concat(batches: list, keys) -> dict:
    return {k: np.concatenate([b[k] for b in batches]) for k in keys}


def stop_actors(actors) -> None:
    for a in actors:
        try:
            ray_tpu_torch.kill(a)
        except Exception:
            pass


class PPO:
    """Algorithm driver (parity: Algorithm.step rllib/algorithms/
    algorithm.py:815 / training_step:1402). The learner runs in the
    driver on `device` (None: the card, raising without one), or with
    num_learners > 1 on a LearnerGroup; the learners are made before the
    rollout workers, so a missing card starts no actor."""

    _BATCH_KEYS = ("obs", "actions", "logp", "advantages", "returns")

    def __init__(self, config: PPOConfig, device=None):
        self.config = config
        probe_env = make_env(config.env)
        self.num_actions = probe_env.num_actions
        self._spec = get_model(config.model)
        if config.model == "atari_cnn":
            obs_in = getattr(probe_env, "observation_shape")
        else:
            obs_in = probe_env.observation_size
        self.obs_size = obs_in
        hidden = config.hidden_size or self._spec.default_hidden

        def fresh_params(seed):
            return self._spec.init_params(obs_in, self.num_actions, hidden,
                                          seed)

        self.learner = None
        self.learners = None
        self._learner_group = None
        self._group_params = None
        if config.policies:
            self.learners = {
                pid: PPOLearner(config, obs_in, self.num_actions,
                                params=fresh_params(config.seed + i),
                                device=device)
                for i, pid in enumerate(sorted(config.policies))}
        elif config.num_learners > 1:
            from ray_tpu_torch.rllib.learner_group import LearnerGroup

            self._learner_group = LearnerGroup(
                num_learners=config.num_learners, model=config.model,
                obs_size=obs_in, num_actions=self.num_actions,
                hidden=hidden, lr=config.lr, clip_param=config.clip_param,
                vf_coeff=config.vf_coeff,
                entropy_coeff=config.entropy_coeff, seed=config.seed,
                device=device)
            # The gang's replicas start from the same seed's params.
            self._group_params = fresh_params(config.seed)
        else:
            self.learner = PPOLearner(config, obs_in, self.num_actions,
                                      params=fresh_params(config.seed),
                                      device=device)
        self.workers = [
            RolloutWorker.remote(config.env, i, config.gamma, config.lam,
                                 config.model)
            for i in range(config.num_rollout_workers)]
        self._agent_mapping = None
        if config.policies:
            self._agent_mapping = {
                a: config.policy_mapping_fn(a)
                for a in probe_env.agent_ids}
        self.iteration = 0

    @property
    def params(self):
        """The single policy's params (numpy), None for multi-agent."""
        if self.learner is not None:
            return self.learner.get_params()
        return self._group_params

    @property
    def policy_params(self):
        """policy_id -> params (numpy) for multi-agent, else None."""
        if self.learners is None:
            return None
        return {pid: lr.get_params() for pid, lr in self.learners.items()}

    def _result(self, episode_returns, n, sample_time, learn_time, aux):
        return {
            "training_iteration": self.iteration,
            "episode_reward_mean": float(np.mean(episode_returns))
            if episode_returns else 0.0,
            "episodes_this_iter": len(episode_returns),
            "timesteps_this_iter": n,
            "sample_time_s": round(sample_time, 3),
            "learn_time_s": round(learn_time, 3),
            **{k: float(v) for k, v in aux.items()},
        }

    def train(self) -> dict:
        """One training iteration: parallel sample -> minibatch SGD epochs."""
        cfg = self.config
        t0 = time.time()
        per_worker = max(cfg.rollout_fragment_length,
                         cfg.train_batch_size // max(1, len(self.workers)))
        if self.learners is not None:
            return self._train_multi_agent(per_worker, t0)
        if self._learner_group is not None:
            # Rollouts sample against the gang's (synchronized) params.
            self._group_params = self._learner_group.get_params()
        host_params = self.params
        batches = ray_tpu_torch.get(
            [w.sample.remote(host_params, per_worker) for w in self.workers],
            timeout=600)
        batch = _concat(batches, self._BATCH_KEYS)
        episode_returns = sum((b["episode_returns"] for b in batches), [])
        sample_time = time.time() - t0

        n = len(batch["obs"])
        t1 = time.time()
        if self._learner_group is not None:
            rng = np.random.default_rng(cfg.seed + self.iteration)
            last_aux = {}
            for _ in range(cfg.num_sgd_iter):
                perm = rng.permutation(n)
                for s in range(0, n, cfg.sgd_minibatch_size):
                    idx = perm[s: s + cfg.sgd_minibatch_size]
                    last_aux = self._learner_group.update(
                        {k: v[idx] for k, v in batch.items()})
            self._group_params = self._learner_group.get_params()
        else:
            last_aux = self.learner.learn(batch, self.iteration)
        learn_time = time.time() - t1
        self.iteration += 1
        return self._result(episode_returns, n, sample_time, learn_time,
                            last_aux)

    def _train_multi_agent(self, per_worker: int, t0: float) -> dict:
        """Multi-agent iteration: per-policy batches from every worker,
        one PPO update stream per policy (parity: reference multi-agent
        training_step updating each policy from its own batch)."""
        host = self.policy_params
        results = ray_tpu_torch.get(
            [w.sample_multi_agent.remote(host, per_worker,
                                         self._agent_mapping)
             for w in self.workers], timeout=600)
        episode_returns = sum((r["episode_returns"] for r in results), [])
        sample_time = time.time() - t0
        t1 = time.time()
        total_steps = 0
        last_aux = {}
        for pid, learner in self.learners.items():
            parts = [r["policy_batches"][pid] for r in results
                     if pid in r["policy_batches"]]
            if not parts:
                continue
            batch = _concat(parts, parts[0])
            total_steps += len(batch["obs"])
            last_aux = learner.learn(batch, self.iteration)
        self.iteration += 1
        return self._result(episode_returns, total_steps, sample_time,
                            time.time() - t1, last_aux)

    def stop(self):
        stop_actors(self.workers)
        if self._learner_group is not None:
            self._learner_group.shutdown()

    def get_policy_params(self, policy_id: str | None = None):
        if self.learners is not None:
            if policy_id is None:
                raise ValueError(
                    "multi-agent PPO: pass policy_id to "
                    f"get_policy_params (policies: {sorted(self.learners)})")
            return self.learners[policy_id].get_params()
        return self.params

    def compute_single_action(self, obs, policy_id: str | None = None) -> int:
        logits, _ = self._spec.numpy_forward(
            self.get_policy_params(policy_id), np.asarray(obs)[None])
        return int(np.argmax(logits[0]))
