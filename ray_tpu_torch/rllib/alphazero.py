"""AlphaZero: self-play MCTS + policy/value network. Port of
ray_tpu/rllib/alphazero.py.

Parity: reference rllib/algorithms/alpha_zero/ (PUCT tree search guided
by a policy/value net, Dirichlet root noise, visit-count targets,
self-play replay; the reference ships it with board-game envs). The
search runs on CPU self-play actors of the port's runtime with the
reference's numpy forward and MCTS, copied as they are; the policy-CE +
value-MSE update runs in `AlphaZeroLearner` on the card (AdamW with
optax.adamw's defaults). Ships TicTacToe as the built-in two-player
zero-sum env.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.ppo import TorchLearner, stop_actors
from ray_tpu_torch.rllib.utils import CPUActor, leaves


class TicTacToe:
    """3x3 zero-sum board. State is always encoded from the perspective
    of the player to move: +1 own stones, -1 opponent's."""

    num_actions = 9
    obs_size = 9

    @staticmethod
    def initial() -> np.ndarray:
        return np.zeros(9, np.float32)

    @staticmethod
    def legal(board: np.ndarray) -> np.ndarray:
        return board == 0

    @staticmethod
    def play(board: np.ndarray, action: int) -> np.ndarray:
        """Apply the to-move player's stone, then flip perspective so
        the returned board is again to-move-relative."""
        nxt = board.copy()
        nxt[action] = 1.0
        return -nxt

    _LINES = [(0, 1, 2), (3, 4, 5), (6, 7, 8), (0, 3, 6), (1, 4, 7),
              (2, 5, 8), (0, 4, 8), (2, 4, 6)]

    @classmethod
    def outcome(cls, board: np.ndarray) -> float | None:
        """Terminal value FOR THE PLAYER TO MOVE at `board` (-1 = the
        previous move won), None if the game continues."""
        for a, b, c in cls._LINES:
            s = board[a] + board[b] + board[c]
            if s == 3:
                return 1.0
            if s == -3:
                return -1.0
        if not (board == 0).any():
            return 0.0
        return None


def init_az_params(obs_size: int = 9, num_actions: int = 9,
                   hidden: int = 64, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o))
                      / np.sqrt(i)).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    return {"h1": dense(obs_size, hidden), "h2": dense(hidden, hidden),
            "pi": dense(hidden, num_actions), "v": dense(hidden, 1)}


def numpy_forward(params: dict, board: np.ndarray):
    h = np.tanh(board @ params["h1"]["w"] + params["h1"]["b"])
    h = np.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = float(np.tanh(h @ params["v"]["w"] + params["v"]["b"])[0])
    e = np.exp(logits - logits.max())
    return e / e.sum(), value


class MCTS:
    """PUCT search (AlphaZero eq.: a* = argmax Q + c_puct P sqrt(N)/
    (1+n)); values backed up with sign flips at each ply."""

    def __init__(self, params: dict, num_simulations: int = 48,
                 c_puct: float = 1.5, dirichlet_alpha: float = 0.6,
                 noise_frac: float = 0.25, rng=None):
        self.params = params
        self.num_simulations = num_simulations
        self.c_puct = c_puct
        self.dirichlet_alpha = dirichlet_alpha
        self.noise_frac = noise_frac
        self.rng = rng or np.random.default_rng()
        # Tree keyed by board bytes: stats per node.
        self.P: dict[bytes, np.ndarray] = {}
        self.N: dict[bytes, np.ndarray] = {}
        self.W: dict[bytes, np.ndarray] = {}

    def policy(self, board: np.ndarray, temperature: float = 1.0
               ) -> np.ndarray:
        """Visit-count distribution after running the simulations."""
        key = board.tobytes()
        if key not in self.P:
            self._simulate(board.copy())  # expand the root
        if self.noise_frac > 0:
            # Dirichlet noise mixed into the ROOT priors once per
            # search, steering every simulation (AlphaZero's self-play
            # exploration; interior nodes stay noise-free).
            legal = TicTacToe.legal(board)
            noise = self.rng.dirichlet(
                [self.dirichlet_alpha] * int(legal.sum()))
            full = np.zeros(9, np.float32)
            full[legal] = noise
            self.P[key] = ((1 - self.noise_frac) * self.P[key]
                           + self.noise_frac * full).astype(np.float32)
        for _ in range(self.num_simulations):
            self._simulate(board.copy())
        n = self.N[key] * TicTacToe.legal(board)
        if temperature == 0:
            pi = np.zeros_like(n)
            pi[int(np.argmax(n))] = 1.0
            return pi
        n = n ** (1.0 / temperature)
        return (n / n.sum()).astype(np.float32)

    def _simulate(self, board: np.ndarray) -> float:
        """One rollout to a leaf; returns the value from the POV of the
        player to move at `board`."""
        outcome = TicTacToe.outcome(board)
        if outcome is not None:
            return outcome
        key = board.tobytes()
        legal = TicTacToe.legal(board)
        if key not in self.P:
            # Leaf: expand with net priors, return net value.
            priors, value = numpy_forward(self.params, board)
            priors = priors * legal
            s = priors.sum()
            priors = priors / s if s > 0 else legal / legal.sum()
            self.P[key] = priors.astype(np.float32)
            self.N[key] = np.zeros(9, np.float32)
            self.W[key] = np.zeros(9, np.float32)
            return value
        p = self.P[key]
        n_total = self.N[key].sum()
        q = np.where(self.N[key] > 0,
                     self.W[key] / np.maximum(self.N[key], 1), 0.0)
        u = self.c_puct * p * math.sqrt(n_total + 1e-8) / (1 + self.N[key])
        scores = np.where(legal, q + u, -np.inf)
        action = int(np.argmax(scores))
        # Child is from the opponent's perspective: flip the value.
        value = -self._simulate(TicTacToe.play(board, action))
        self.N[key][action] += 1
        self.W[key][action] += value
        return value


@ray_tpu_torch.remote(num_cpus=1)
class SelfPlayWorker(CPUActor):
    """CPU self-play actor: full games of MCTS vs itself, emitting
    (board, visit-count pi, final z from that board's POV)."""

    def __init__(self, worker_index: int, num_simulations: int):
        super().__init__()
        self.rng = np.random.default_rng(6000 + worker_index)
        self.num_simulations = num_simulations

    def play_games(self, params: dict, num_games: int) -> dict:
        boards, pis, zs = [], [], []
        for _ in range(num_games):
            tree = MCTS(params, self.num_simulations, rng=self.rng)
            board = TicTacToe.initial()
            traj = []
            ply = 0
            while True:
                temp = 1.0 if ply < 4 else 0.25
                pi = tree.policy(board, temperature=temp)
                traj.append((board.copy(), pi))
                action = int(self.rng.choice(9, p=pi))
                board = TicTacToe.play(board, action)
                ply += 1
                outcome = TicTacToe.outcome(board)
                if outcome is not None:
                    # outcome is from the NEW to-move player's POV; walk
                    # back flipping signs.
                    z = outcome
                    for b, p in reversed(traj):
                        z = -z
                        boards.append(b)
                        pis.append(p)
                        zs.append(z)
                    break
        return {"boards": np.asarray(boards, np.float32),
                "pis": np.asarray(pis, np.float32),
                "zs": np.asarray(zs, np.float32),
                "games": num_games}


@dataclass
class AlphaZeroConfig:
    """Parity: rllib AlphaZeroConfig (mcts_config + sgd settings)."""

    num_rollout_workers: int = 2
    games_per_iteration: int = 8
    num_simulations: int = 48
    buffer_capacity: int = 8_000
    train_batch_size: int = 128
    num_sgd_iter: int = 24
    lr: float = 3e-3
    hidden_size: int = 64
    weight_decay: float = 1e-4
    seed: int = 0

    def rollouts(self, num_rollout_workers: int | None = None, **kw):
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown AlphaZero option {k!r}")
            setattr(self, k, v)
        return self

    def build(self, device=None) -> "AlphaZero":
        """device: where the learner runs; None means the card, and
        raises without one."""
        return AlphaZero(self, device=device)


def az_forward(params, boards):
    """numpy_forward on a batch of tensors: (policy logits, value)."""
    h = torch.tanh(boards @ params["h1"]["w"] + params["h1"]["b"])
    h = torch.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = torch.tanh(h @ params["v"]["w"] + params["v"]["b"])[:, 0]
    return logits, value


def az_loss(params, batch):
    logits, value = az_forward(params, batch["boards"])
    ce = -(batch["pis"] * torch.log_softmax(logits, -1)).sum(-1).mean()
    mse = torch.mean((value - batch["zs"]) ** 2)
    return ce + mse, {}


class AlphaZeroLearner(TorchLearner):
    """AlphaZero's learner on one device: the policy/value net, one AdamW
    step (optax.adamw: the decay scaled by lr, applied to every leaf) an
    update of visit-count cross-entropy plus value MSE."""

    def __init__(self, config: AlphaZeroConfig, *, params: dict | None = None,
                 device=None):
        self.config = config
        if params is None:
            params = init_az_params(hidden=config.hidden_size,
                                    seed=config.seed)
        super().__init__(params, az_loss, config.lr, device)
        self.optimizer = torch.optim.AdamW(
            leaves(self.params), lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=config.weight_decay)


class AlphaZero:
    """Algorithm driver (parity: Algorithm.step / AlphaZero
    training_step): parallel self-play -> replay -> an update on the card.
    The learner is made before the self-play workers."""

    def __init__(self, config: AlphaZeroConfig, device=None):
        self.config = config
        self.learner = AlphaZeroLearner(config, device=device)
        cap = config.buffer_capacity
        self.boards = np.zeros((cap, 9), np.float32)
        self.pis = np.zeros((cap, 9), np.float32)
        self.zs = np.zeros(cap, np.float32)
        self.pos = 0
        self.size = 0
        self.rng = np.random.default_rng(config.seed)
        self.workers = [
            SelfPlayWorker.remote(i, config.num_simulations)
            for i in range(config.num_rollout_workers)]
        self.iteration = 0
        self.total_games = 0

    @property
    def params(self) -> dict:
        return self.learner.get_params()

    def train(self) -> dict:
        cfg = self.config
        per = max(1, cfg.games_per_iteration // len(self.workers))
        rollout_params = self.learner.get_params()
        outs = ray_tpu_torch.get([w.play_games.remote(rollout_params, per)
                                  for w in self.workers])
        for out in outs:
            n = len(out["boards"])
            idx = (self.pos + np.arange(n)) % cfg.buffer_capacity
            self.boards[idx] = out["boards"]
            self.pis[idx] = out["pis"]
            self.zs[idx] = out["zs"]
            self.pos = int((self.pos + n) % cfg.buffer_capacity)
            self.size = int(min(self.size + n, cfg.buffer_capacity))
            self.total_games += out["games"]
        losses = []
        if self.size >= cfg.train_batch_size:
            for _ in range(cfg.num_sgd_iter):
                idx = self.rng.integers(0, self.size,
                                        cfg.train_batch_size)
                batch = {"boards": self.boards[idx], "pis": self.pis[idx],
                         "zs": self.zs[idx]}
                loss, _aux = self.learner.update(batch)
                losses.append(loss)
        self.iteration += 1
        return {"training_iteration": self.iteration,
                "games_played": self.total_games,
                "loss": float(np.mean(torch.stack(losses).tolist()))
                if losses else None}

    def stop(self):
        stop_actors(self.workers)

    def eval_vs_random(self, num_games: int = 40,
                       num_simulations: int | None = None) -> float:
        """Fraction of non-lost games (win=1, draw=0.5) playing half the
        games as each side against a uniform-random opponent."""
        sims = num_simulations or self.config.num_simulations
        params = self.learner.get_params()
        rng = np.random.default_rng(123)
        score = 0.0
        for g in range(num_games):
            az_to_move = (g % 2 == 0)
            board = TicTacToe.initial()
            tree = MCTS(params, sims, noise_frac=0.0, rng=rng)
            while True:
                if az_to_move:
                    pi = tree.policy(board, temperature=0.0)
                    action = int(np.argmax(pi))
                else:
                    legal = np.flatnonzero(TicTacToe.legal(board))
                    action = int(rng.choice(legal))
                board = TicTacToe.play(board, action)
                outcome = TicTacToe.outcome(board)
                mover_was_az = az_to_move
                az_to_move = not az_to_move
                if outcome is not None:
                    # outcome is for the player NOW to move; -outcome is
                    # the mover's result.
                    res = -outcome
                    if res > 0:
                        score += 1.0 if mover_was_az else 0.0
                    elif res == 0:
                        score += 0.5
                    break
        return score / num_games
