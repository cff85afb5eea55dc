"""Model catalog. Port of ray_tpu/rllib/catalog.py (parity: reference
rllib/models/catalog.py — maps spec → network). Every algorithm uses the
same dual-representation policy: a numpy forward for CPU rollout actors
(no torch in samplers) and a torch forward for the learner. The numpy
halves (`init_params`, `numpy_forward`) are copies of the reference's,
so both packages draw bitwise the same initial weights from a seed.

Params are nested dicts {"layer": {"w": ..., "b": ...}}: numpy arrays
for the numpy forward, tensors for `torch_forward`. Dense weights are
(in, out) and conv kernels HWIO, as in the reference; the torch forward
permutes them where torch wants another layout."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

MODEL_REGISTRY: dict[str, "ModelSpec"] = {}


@dataclass
class ModelSpec:
    name: str
    init_params: Callable  # (obs_size, num_actions, hidden, seed) -> params
    numpy_forward: Callable  # (params, obs) -> (logits, value)
    torch_forward: Callable  # same contract over tensors, differentiable
    default_hidden: int = 64  # the spec owns its width default


def register_model(spec: ModelSpec) -> None:
    MODEL_REGISTRY[spec.name] = spec


def get_model(name: str) -> ModelSpec:
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; registered: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name]


def _heads(params: dict, h):
    logits = h @ params["pi"]["w"] + params["pi"]["b"]
    value = (h @ params["vf"]["w"] + params["vf"]["b"])[..., 0]
    return logits, value


# -- built-in: 2-layer tanh MLP actor-critic (the default everywhere) ------

def _mlp_init(obs_size: int, num_actions: int, hidden: int = 64,
              seed: int = 0) -> dict:
    from ray_tpu_torch.rllib.ppo import init_policy_params

    return init_policy_params(obs_size, num_actions, hidden, seed)


def _mlp_numpy(params: dict, obs: np.ndarray):
    from ray_tpu_torch.rllib.ppo import numpy_forward

    return numpy_forward(params, obs)


def _mlp_torch(params: dict, obs):
    h = torch.tanh(obs @ params["h1"]["w"] + params["h1"]["b"])
    h = torch.tanh(h @ params["h2"]["w"] + params["h2"]["b"])
    return _heads(params, h)


register_model(ModelSpec("mlp", _mlp_init, _mlp_numpy, _mlp_torch))


# -- deeper residual MLP for harder control tasks --------------------------

def _resmlp_init(obs_size: int, num_actions: int, hidden: int = 128,
                 seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    return {"inp": dense(obs_size, hidden),
            "res1": dense(hidden, hidden), "res2": dense(hidden, hidden),
            "pi": dense(hidden, num_actions), "vf": dense(hidden, 1)}


def _resmlp_numpy(params, obs):
    h = np.tanh(obs @ params["inp"]["w"] + params["inp"]["b"])
    h = h + np.tanh(h @ params["res1"]["w"] + params["res1"]["b"])
    h = h + np.tanh(h @ params["res2"]["w"] + params["res2"]["b"])
    return _heads(params, h)


def _resmlp_torch(params, obs):
    h = torch.tanh(obs @ params["inp"]["w"] + params["inp"]["b"])
    h = h + torch.tanh(h @ params["res1"]["w"] + params["res1"]["b"])
    h = h + torch.tanh(h @ params["res2"]["w"] + params["res2"]["b"])
    return _heads(params, h)


register_model(ModelSpec("resmlp", _resmlp_init, _resmlp_numpy,
                         _resmlp_torch))


# -- Atari-style conv net (parity: reference rllib Nature-CNN default for
# image observations). Used for pixel envs: obs (B, H, W, C) uint8 or
# float; three stride-2 convs with symmetric k//2 padding shrink H and W
# by 2 each (84 -> 42 -> 21 -> 11), then a tanh dense layer. -------------

def _cnn_init(obs_shape, num_actions: int, hidden: int = 256,
              seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    h, w, c = obs_shape

    def conv(kh, kw, cin, cout):
        fan_in = kh * kw * cin
        return {"w": (rng.standard_normal((kh, kw, cin, cout))
                      / np.sqrt(fan_in)).astype(np.float32),
                "b": np.zeros(cout, np.float32)}

    def dense(i, o):
        return {"w": (rng.standard_normal((i, o)) / np.sqrt(i)
                      ).astype(np.float32),
                "b": np.zeros(o, np.float32)}

    # Strided convs shrink H,W by 2 each: 42 -> 21 -> 11 -> 6.
    def out_hw(x):
        for _ in range(3):
            x = (x + 1) // 2
        return x

    flat = out_hw(h) * out_hw(w) * 64
    return {
        "c1": conv(5, 5, c, 16),
        "c2": conv(3, 3, 16, 32),
        "c3": conv(3, 3, 32, 64),
        "fc": dense(flat, hidden),
        "pi": dense(hidden, num_actions),
        "vf": dense(hidden, 1),
    }


def _cnn_torch(params: dict, obs):
    """obs: (B, H, W, C); [0,255] inputs are normalized, by a switch on
    the batch's largest value that stays on the device. The reference's
    convs are NHWC with HWIO kernels: here the input is permuted to NCHW
    and each kernel to OIHW, and the last conv's output back to NHWC
    before the flatten, so that `fc`'s rows keep their meaning."""
    x = obs.float()
    x = x / torch.where(x.max() > 1.5, 255.0, 1.0).clamp_min(1.0)
    x = x.permute(0, 3, 1, 2)
    for key in ("c1", "c2", "c3"):
        w = params[key]["w"]
        kh, kw = w.shape[0], w.shape[1]
        x = F.conv2d(x, w.permute(3, 2, 0, 1), stride=2,
                     padding=(kh // 2, kw // 2))
        x = F.relu(x + params[key]["b"][:, None, None])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    h = torch.tanh(x @ params["fc"]["w"] + params["fc"]["b"])
    return _heads(params, h)


def _cnn_numpy(params: dict, obs: np.ndarray):
    """Fallback numpy path (tests / environments without torch): naive but
    correct strided conv."""
    x = obs.astype(np.float32)
    if x.max() > 1.5:
        x = x / 255.0

    def conv2d(x, w, b):
        bsz, hh, ww, cin = x.shape
        kh, kw, _, cout = w.shape
        ph, pw = kh // 2, kw // 2
        xp = np.pad(x, ((0, 0), (ph, ph), (pw, pw), (0, 0)))
        oh, ow = (hh + 1) // 2, (ww + 1) // 2
        out = np.zeros((bsz, oh, ow, cout), np.float32)
        for i in range(oh):
            for j in range(ow):
                patch = xp[:, i * 2:i * 2 + kh, j * 2:j * 2 + kw, :]
                out[:, i, j, :] = np.tensordot(patch, w, axes=([1, 2, 3],
                                                               [0, 1, 2]))
        return np.maximum(out + b, 0.0)

    for key in ("c1", "c2", "c3"):
        x = conv2d(x, params[key]["w"], params[key]["b"])
    x = x.reshape(x.shape[0], -1)
    h = np.tanh(x @ params["fc"]["w"] + params["fc"]["b"])
    return _heads(params, h)


register_model(ModelSpec("atari_cnn", _cnn_init, _cnn_numpy, _cnn_torch,
                         default_hidden=256))
