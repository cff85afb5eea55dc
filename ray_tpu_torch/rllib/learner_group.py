"""Distributed learner gang: N learner actors with synchronized updates.
Port of ray_tpu/rllib/learner_group.py.

Parity: reference rllib/core/learner/learner_group.py — remote Learner
workers each hold a model replica, compute gradients on their shard of
every batch, and synchronize via an allreduce before applying updates
(the reference wraps modules in torch DDP, torch_learner.py:368). Here
the gradient plane is a `ray_tpu_torch.util.collective` group: NCCL
where each learner holds a card of its own, gloo where learners share a
card (two ranks on one card cannot form an NCCL communicator) or run on
the CPU. Each learner applies the SAME reduced gradient with the same
torch Adam step, so parameters stay bit-identical across the gang
without any parameter server.

Update cycle per minibatch:
  1. each learner computes grads on its 1/N shard of the batch
  2. grads flatten, in the reference's sorted-key leaf order, to ONE
     contiguous f32 vector -> allreduce (sum) / N
  3. each learner applies the mean with its own torch Adam
Optimizer state lives replicated: every learner holds the full state,
advanced identically. `get_state`/`set_state` carry torch Adam's state
(the reference's blob pickles optax state, which has no meaning here).

Placement: with device=None each learner leases GPUs through the
runtime: a whole card where the cluster has a card per learner, else an
equal share of one; device="cpu" leases none.
"""

from __future__ import annotations

import hashlib
import pickle
import time

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch._device import device_context, resolve_device
from ray_tpu_torch.rllib.ppo import (adam, adam_state, device_batch,
                                     load_reference_state, numpy_params,
                                     sorted_items, stop_actors,
                                     tensor_params)


def _full_f32() -> None:
    """Full f32 on the card (cuDNN's convolutions default to TF32), so a
    gang's step agrees with the CPU's within 1e-4. A module function: the
    actor class pickles by value, and torch.backends.cudnn does not."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@ray_tpu_torch.remote(num_cpus=1)
class LearnerActor:
    """One member of the gang (reference: Learner, rllib/core/learner).
    device: "cpu", or None for the card its lease pins (cuda:0 here);
    backend: the collective group's, "nccl" or "gloo"."""

    def __init__(self, rank: int, world: int, group_name: str, model: str,
                 obs_size, num_actions: int, hidden: int, lr: float,
                 clip_param: float, vf_coeff: float, entropy_coeff: float,
                 seed: int, algo: str = "ppo",
                 algo_kwargs: dict | None = None, device=None,
                 backend: str = "gloo"):
        from ray_tpu_torch.rllib.catalog import get_model

        torch.set_num_threads(1)     # the lease's one CPU
        self.rank, self.world, self.group = rank, world, group_name
        self.backend = backend
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            _full_f32()
        spec = get_model(model)
        # Same seed everywhere => bit-identical initial replicas (the
        # reference broadcasts from rank 0; identical init is equivalent
        # and needs no traffic).
        self.params = tensor_params(
            spec.init_params(obs_size, num_actions, hidden, seed),
            self.device, trainable=True)
        self.optimizer = adam(self.params, lr)
        self._order = [t for _, t in sorted_items(self.params)]
        # Pluggable loss: sync algos shard one batch row-wise (PPO);
        # async algos feed whole trajectory fragments per learner
        # (IMPALA — V-trace needs intact sequences). Reference:
        # rllib/core/learner builds per-algo Learner classes over one
        # LearnerGroup.
        if algo == "ppo":
            from ray_tpu_torch.rllib.ppo import make_ppo_loss

            self._loss_fn = make_ppo_loss(spec.torch_forward, clip_param,
                                          vf_coeff, entropy_coeff)
        elif algo == "impala":
            from ray_tpu_torch.rllib.impala import make_impala_loss

            self._loss_fn = make_impala_loss(
                vf_coeff=vf_coeff, entropy_coeff=entropy_coeff,
                **(algo_kwargs or {}))
        else:
            raise ValueError(f"unknown learner algo {algo!r}")
        self._comm = {"updates": 0, "allreduce_s": 0.0,
                      "allreduce_bytes": 0}

    def join_group(self) -> bool:
        from ray_tpu_torch.util import collective

        collective.init_collective_group(self.world, self.rank,
                                         backend=self.backend,
                                         group_name=self.group)
        return True

    def leave_group(self) -> bool:
        from ray_tpu_torch.util import collective

        collective.destroy_collective_group(self.group)
        return True

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def update(self, batch: dict) -> dict:
        """One synchronized step on this learner's shard of the batch:
        local grads -> allreduce(mean) of the flat f32 gradient ->
        identical Adam step."""
        from ray_tpu_torch.util import collective

        with device_context(self.device):
            data = device_batch(batch, self.device)
            self.optimizer.zero_grad(set_to_none=True)
            loss, aux = self._loss_fn(self.params, data)
            loss.backward()
            flat = torch.cat([(t.grad if t.grad is not None
                               else torch.zeros_like(t)).reshape(-1)
                              for t in self._order])
            if self.world > 1:
                self._sync()
                t0 = time.perf_counter()
                collective.allreduce(flat, group_name=self.group)
                flat.div_(self.world)
                self._sync()
                self._comm["allreduce_s"] += time.perf_counter() - t0
                self._comm["allreduce_bytes"] += flat.numel() * 4
            off = 0
            for t in self._order:
                n = t.numel()
                t.grad = flat[off:off + n].view_as(t)
                off += n
            self.optimizer.step()
            self._comm["updates"] += 1
            return {"loss": loss.item(),
                    **{k: float(v) for k, v in aux.items()}}

    def get_params(self):
        return numpy_params(self.params)

    def params_fingerprint(self) -> str:
        """SHA1 over every parameter byte in the reference's leaf order —
        the gang-sync check (equal to the reference's fingerprint of the
        same params)."""
        h = hashlib.sha1()
        for t in self._order:
            h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
        return h.hexdigest()

    def comm_stats(self) -> dict:
        """Updates taken, and the seconds and bytes of their gradient
        means (the allreduce and the division, the card synchronised
        before and after)."""
        return dict(self._comm)

    def get_state(self) -> bytes:
        return pickle.dumps({"params": numpy_params(self.params),
                             "opt_state": adam_state(self)})

    def set_state(self, blob: bytes) -> bool:
        st = pickle.loads(blob)
        opt = st["opt_state"]
        load_reference_state(self, st["params"], opt["count"], opt["mu"],
                             opt["nu"])
        return True


class LearnerGroup:
    """Owns the gang (reference: LearnerGroup — spawn, rendezvous,
    sharded update fan-out, checkpoint). device: None means the card
    (raises where the cluster has none), "cpu" runs the learners on the
    CPU over gloo."""

    _seq = 0

    def __init__(self, *, num_learners: int, model: str, obs_size,
                 num_actions: int, hidden: int, lr: float,
                 clip_param: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.0, seed: int = 0,
                 algo: str = "ppo", algo_kwargs: dict | None = None,
                 device=None):
        LearnerGroup._seq += 1
        self.group_name = f"learner-gang-{LearnerGroup._seq}"
        self.num_learners = num_learners
        self.num_gpus, self.backend = self._placement(num_learners, device)
        cls = LearnerActor.options(num_gpus=self.num_gpus) \
            if self.num_gpus else LearnerActor
        self.learners = [
            cls.remote(rank, num_learners, self.group_name, model,
                       obs_size, num_actions, hidden, lr, clip_param,
                       vf_coeff, entropy_coeff, seed, algo, algo_kwargs,
                       None if self.num_gpus else "cpu", self.backend)
            for rank in range(num_learners)]
        # Rendezvous: every member joins the group before the first update.
        ray_tpu_torch.get([a.join_group.remote() for a in self.learners],
                          timeout=120)

    @staticmethod
    def _placement(n: int, device) -> tuple:
        """(GPUs a learner leases, the group's backend)."""
        if device is not None and torch.device(device).type == "cpu":
            return 0, "gloo"
        cards = ray_tpu_torch.cluster_resources().get("GPU", 0)
        if cards < 1:
            raise RuntimeError(
                "LearnerGroup: device=None puts the learners on the "
                "cluster's cards and it has none; pass device='cpu' to "
                "run them on the CPU")
        if cards >= n:
            return 1, "nccl"
        return 1.0 / n, "gloo"

    def update(self, batch: dict) -> dict:
        """One synchronized SGD step over the whole batch: each learner
        takes its 1/N shard; gradients allreduce inside the actors."""
        n = self.num_learners
        shards = [
            {k: np.array_split(v, n)[i] for k, v in batch.items()}
            for i in range(n)]
        return self.update_shards(shards)

    def update_shards(self, shards: list[dict]) -> dict:
        """One synchronized step with an EXPLICIT batch per learner —
        the async-algo path (IMPALA hands each learner a whole
        trajectory fragment; V-trace sequences cannot be row-split)."""
        assert len(shards) == self.num_learners
        metrics = ray_tpu_torch.get(
            [a.update.remote(s) for a, s in zip(self.learners, shards)],
            timeout=600)
        # Means across learners (each reports its local loss).
        return {k: float(np.mean([m[k] for m in metrics]))
                for k in metrics[0]}

    def get_params(self):
        return ray_tpu_torch.get(self.learners[0].get_params.remote(),
                                 timeout=120)

    def fingerprints(self) -> list[str]:
        return ray_tpu_torch.get(
            [a.params_fingerprint.remote() for a in self.learners],
            timeout=120)

    def comm_stats(self) -> list[dict]:
        """Each learner's updates and its gradient means' seconds and
        bytes (LearnerActor.comm_stats)."""
        return ray_tpu_torch.get([a.comm_stats.remote()
                                  for a in self.learners], timeout=120)

    def save_state(self) -> bytes:
        """Checkpoint (params + Adam state) from rank 0 — state is
        bit-identical across the gang by construction."""
        return ray_tpu_torch.get(self.learners[0].get_state.remote(),
                                 timeout=120)

    def restore_state(self, blob: bytes) -> None:
        ray_tpu_torch.get([a.set_state.remote(blob) for a in self.learners],
                          timeout=120)

    def shutdown(self) -> None:
        try:
            ray_tpu_torch.get([a.leave_group.remote()
                               for a in self.learners], timeout=60)
        except Exception:
            pass
        stop_actors(self.learners)
        self.learners = []
