"""Weights for the port's decoders (the Llama and the MoE model): from a
flax parameter tree, or drawn anew. Both functions dispatch on the
config's type (`model_class`).

`params_from_flax` maps the flax tree of ray_tpu.models.llama or
ray_tpu.models.moe onto the port's state_dict: a Dense `kernel` (in, out)
becomes a Linear `weight` (out, in); `embed/embedding`, the RMSNorm
`scale`s and the MoE experts' raw (E, in, out) kernels copy across. bf16
arrays (ml_dtypes) cross as their uint16 bits, so the copy is bit-exact.

`init_params` draws flax's default initializers for runs without a
checkpoint, from a seeded torch.Generator on the target device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel
from ray_tpu_torch.models.moe import MoEConfig, MoEModel

MODELS = {LlamaConfig: LlamaModel, MoEConfig: MoEModel}

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled by the std of the unit normal so truncated (scipy's value).
_TRUNC_STD = 0.87962566103423978


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy refuses it
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def model_class(cfg: LlamaConfig | MoEConfig):
    """The port's model class for a config: LlamaModel or MoEModel."""
    return MODELS[type(cfg)]


def params_from_flax(tree, cfg: LlamaConfig | MoEConfig
                     ) -> dict[str, torch.Tensor]:
    """tree: the flax variables (`{"params": ...}`) or the params dict,
    holding numpy arrays, of the JAX model of cfg's type. Returns CPU
    tensors keyed as the port's model names them."""
    p = tree.get("params", tree)

    def weight(kernel):  # flax (in, out) -> torch (out, in)
        return _tensor(kernel).t().contiguous()

    out = {"embed.weight": _tensor(p["embed"]["embedding"])}
    for i in range(cfg.n_layers):
        lp, pre = p[f"layers_{i}"], f"layers.{i}."
        out[pre + "input_norm.scale"] = _tensor(lp["input_norm"]["scale"])
        out[pre + "post_attn_norm.scale"] = _tensor(
            lp["post_attn_norm"]["scale"])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            out[pre + f"attn.{name}.weight"] = weight(lp["attn"][name]["kernel"])
        if isinstance(cfg, MoEConfig):
            mp = lp["moe"]
            out[pre + "moe.router.weight"] = weight(mp["router"]["kernel"])
            for name in ("w_gate", "w_up", "w_down"):
                out[pre + f"moe.{name}"] = _tensor(mp[name])
        else:
            for name in ("gate_proj", "up_proj", "down_proj"):
                out[pre + f"mlp.{name}.weight"] = weight(
                    lp["mlp"][name]["kernel"])
    out["norm.scale"] = _tensor(p["norm"]["scale"])
    if not getattr(cfg, "tie_embeddings", False):
        out["lm_head.weight"] = weight(p["lm_head"]["kernel"])
    return out


@torch.no_grad()
def init_params(cfg: LlamaConfig | MoEConfig, seed: int = 0,
                device=None) -> dict[str, torch.Tensor]:
    """flax's default initializers: Dense kernels lecun_normal (truncated
    normal, std 1/sqrt(fan_in)), the embedding normal with std
    1/sqrt(d_model), RMSNorm scales one. lecun_normal takes the leading
    dims of a kernel of more than two as its receptive field, so an
    expert kernel (E, in, out) has fan_in E * in. Drawn in f32, stored in
    the model's dtypes (the MoE router's is f32)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {}
    model = model_class(cfg)(cfg, device="meta")
    for name, meta in model.state_dict().items():
        if name.endswith(".scale"):
            t = torch.ones(meta.shape, dtype=torch.float32, device=device)
        elif name == "embed.weight":
            t = torch.empty(meta.shape, dtype=torch.float32, device=device)
            t.normal_(0.0, cfg.d_model ** -0.5, generator=gen)
        else:
            # a Linear weight (out, in): fan_in is the second dim; a raw
            # kernel in the flax layout (..., in, out): all but the last
            fan_in = meta.shape[1] if name.endswith(".weight") \
                else math.prod(meta.shape[:-1])
            t = torch.empty(meta.shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            t.mul_(fan_in ** -0.5 / _TRUNC_STD)
        params[name] = t.to(meta.dtype)
    return params
