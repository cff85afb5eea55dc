"""Small shared helpers for RLlib algorithm modules. Port of
ray_tpu/rllib/utils.py.

Parity: reference rllib/utils/ (tree utilities over nested param
structures): plain dict/list trees whose leaves are numpy arrays or
torch tensors, shared by every off-policy driver."""

from __future__ import annotations

import sys

import numpy as np
import torch

# torch's intra-op threads in a rollout worker: the one CPU its lease
# holds (the default, every core, oversubscribes the host once two
# workers run the CNN forward).
ROLLOUT_THREADS = 1


def tree_copy(t):
    """Deep copy of a nested dict/list/tuple tree: a tensor leaf becomes a
    detached clone on its own device (a target network's snapshot), any
    other leaf a fresh ndarray."""
    if isinstance(t, dict):
        return {k: tree_copy(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        out = [tree_copy(v) for v in t]
        return type(t)(out) if isinstance(t, tuple) else out
    if isinstance(t, torch.Tensor):
        return t.detach().clone()
    return np.array(t).copy()


def tree_numpy(t):
    """Nested tree with every leaf a host ndarray, the form CPU rollout
    workers consume: numpy leaves as they are (no copy), tensor leaves
    copied to the host (a CPU tensor's .numpy() would alias it, and the
    next update would change what was handed out)."""
    if isinstance(t, dict):
        return {k: tree_numpy(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        out = [tree_numpy(v) for v in t]
        return type(t)(out) if isinstance(t, tuple) else out
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", copy=True).numpy()
    return np.asarray(t)


def leaves(tree) -> list:
    """The tree's leaves, in its keys' (and lists') order."""
    children = tree.values() if isinstance(tree, dict) else tree
    return [t for v in children
            for t in (leaves(v) if isinstance(v, (dict, list, tuple))
                      else [v])]


def tree_assign(target, source) -> None:
    """Copies a tensor tree into a same-shaped tensor tree (built in the
    same key order, as tree_copy builds it) in place: a target network's
    hard sync."""
    with torch.no_grad():
        torch._foreach_copy_(leaves(target), leaves(source))


def polyak(target, source, tau: float) -> None:
    """target <- (1 - tau) * target + tau * source, leaf by leaf, in place:
    the reference's tree_map(lambda t, p: (1 - tau) * t + tau * p)."""
    with torch.no_grad():
        for t, p in zip(leaves(target), leaves(source)):
            t.copy_((1 - tau) * t + tau * p)


def tree_detach(t):
    """The tree with every tensor detached (the reference's
    jax.lax.stop_gradient over a params subtree)."""
    if isinstance(t, dict):
        return {k: tree_detach(v) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [tree_detach(v) for v in t]
    return t.detach()


class CPUActor:
    """Base of the rollout and self-play actors: declared with
    num_cpus=1, torch on ROLLOUT_THREADS threads, no card, and the CUDA
    context never made."""

    def __init__(self):
        torch.set_num_threads(ROLLOUT_THREADS)

    def process_state(self) -> dict:
        """What this worker process has loaded: the top-level packages in
        sys.modules, whether CUDA is initialised, torch's threads."""
        import sys

        return {"packages": sorted({m.split(".")[0] for m in sys.modules}),
                "cuda_initialized": torch.cuda.is_initialized(),
                "threads": torch.get_num_threads()}
