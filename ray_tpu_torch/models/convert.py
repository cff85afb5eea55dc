"""Weights for the port's models: from a flax parameter tree, or drawn
anew. Both functions dispatch on the config's type (`model_class`).

`params_from_flax` maps the flax tree of the JAX package's model onto the
port's state_dict, each name through `parallel.sharding.flax_path`: a
Dense `kernel` (in, out) becomes a Linear `weight` (out, in), a Conv
`kernel` (kh, kw, in, out) a Conv2d `weight` (out, in, kh, kw); an
`embedding`, the norms' `scale` and `bias`, the Dense biases and the raw
parameters (the MoE experts' (E, in, out) kernels, the SSM's `conv_w`,
`a_log`, `d_skip`, the positional tables) copy across. bf16 arrays
(ml_dtypes) cross as their uint16 bits, so the copy is bit-exact.

`init_params` draws flax's default initializers for runs without a
checkpoint, from a seeded torch.Generator on the target device.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.dit import DiT, DiTConfig
from ray_tpu_torch.models.encoder import (EncDecConfig, Encoder,
                                          EncoderConfig, EncoderDecoder)
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
from ray_tpu_torch.models.moe import MoEConfig, MoEModel
from ray_tpu_torch.models.ssm import SSMConfig, SSMModel
from ray_tpu_torch.models.vit import ViT, ViTConfig
from ray_tpu_torch.parallel.sharding import flax_path

MODELS = {LlamaConfig: LlamaModel, MoEConfig: MoEModel, ViTConfig: ViT,
          DiTConfig: DiT, EncoderConfig: Encoder,
          EncDecConfig: EncoderDecoder, SSMConfig: SSMModel}

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled by the std of the unit normal so truncated (scipy's value).
_TRUNC_STD = 0.87962566103423978


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy refuses it
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def model_class(cfg):
    """The port's model class for a config (LlamaConfig: LlamaModel, ...,
    SSMConfig: SSMModel)."""
    return MODELS[type(cfg)]


def params_from_flax(tree, cfg) -> dict[str, torch.Tensor]:
    """tree: the flax variables (`{"params": ...}`) or the params dict,
    holding numpy arrays, of the JAX model of cfg's type. Returns CPU
    tensors keyed as the port's model names them."""
    p = tree.get("params", tree)
    out = {}
    for name, meta in model_class(cfg)(cfg, device="meta").state_dict() \
            .items():
        path, perm = flax_path(name, meta.dim())
        leaf = p
        for key in path.split("/"):
            leaf = leaf[key]
        t = _tensor(leaf)
        out[name] = t.permute(perm).contiguous() if perm else t
    return out


@torch.no_grad()
def init_params(cfg, seed: int = 0, device=None) -> dict[str, torch.Tensor]:
    """flax's default initializers: Dense and Conv kernels lecun_normal
    (truncated normal, std 1/sqrt(fan_in)), embeddings normal with std
    1/sqrt(features), norm scales one, biases zero, and the raw
    parameters as each model's `raw_init` says (the reference's own
    initializers: zeros, ones, a normal of a given std; adaLN-Zero's
    zero kernels). lecun_normal takes the leading dims of a raw kernel of
    more than two as its receptive field, so an expert kernel (E, in,
    out) has fan_in E * in. Drawn in f32, stored in the model's dtypes."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = model_class(cfg)(cfg, device="meta")
    raw = [(re.compile(pat), how) for pat, how in model.raw_init.items()]
    embeddings = {f"{n}.weight" for n, m in model.named_modules()
                  if isinstance(m, nn.Embedding)}
    params = {}
    for name, meta in model.state_dict().items():
        t = torch.empty(meta.shape, dtype=torch.float32, device=device)
        how = next((h for pat, h in raw if pat.search(name)), None)
        if how is not None:
            if how[0] == "normal":
                t.normal_(0.0, how[1], generator=gen)
            else:
                t.fill_({"zeros": 0.0, "ones": 1.0}[how[0]])
        elif name.endswith(".scale"):
            t.fill_(1.0)
        elif name.endswith(".bias"):
            t.zero_()
        elif name in embeddings:
            t.normal_(0.0, meta.shape[1] ** -0.5, generator=gen)
        else:
            # a Linear or Conv2d weight (out, in, ...): fan_in is all but
            # the first dim; a raw kernel in the flax layout (..., in,
            # out): all but the last
            fan_in = math.prod(meta.shape[1:]) if name.endswith(".weight") \
                else math.prod(meta.shape[:-1])
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            t.mul_(fan_in ** -0.5 / _TRUNC_STD)
        params[name] = t.to(meta.dtype)
    return params
