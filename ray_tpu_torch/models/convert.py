"""Weights for the port's Llama: from a flax parameter tree, or drawn anew.

`params_from_flax` maps the flax tree of ray_tpu.models.llama onto the
port's state_dict: a Dense `kernel` (in, out) becomes a Linear `weight`
(out, in); `embed/embedding` and the RMSNorm `scale`s copy across. bf16
arrays (ml_dtypes) cross as their uint16 bits, so the copy is bit-exact.

`init_params` draws flax's default initializers for runs without a
checkpoint, from a seeded torch.Generator on the target device.
"""

from __future__ import annotations

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, LlamaModel

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled by the std of the unit normal so truncated (scipy's value).
_TRUNC_STD = 0.87962566103423978


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch.from_numpy refuses it
        return torch.from_numpy(np.array(a.view(np.uint16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_flax(tree, cfg: LlamaConfig) -> dict[str, torch.Tensor]:
    """tree: the flax variables (`{"params": ...}`) or the params dict,
    holding numpy arrays. Returns CPU tensors keyed as the port's
    LlamaModel names them."""
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
        for name in ("gate_proj", "up_proj", "down_proj"):
            out[pre + f"mlp.{name}.weight"] = weight(lp["mlp"][name]["kernel"])
    out["norm.scale"] = _tensor(p["norm"]["scale"])
    if not cfg.tie_embeddings:
        out["lm_head.weight"] = weight(p["lm_head"]["kernel"])
    return out


@torch.no_grad()
def init_params(cfg: LlamaConfig, seed: int = 0,
                device=None) -> dict[str, torch.Tensor]:
    """flax's default initializers: Dense kernels lecun_normal (truncated
    normal, std 1/sqrt(fan_in)), the embedding normal with std
    1/sqrt(d_model), RMSNorm scales one. Drawn in f32, stored in the
    model's dtypes."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {}
    for name, meta in LlamaModel(cfg, device="meta").state_dict().items():
        if name.endswith(".scale"):
            t = torch.ones(meta.shape, dtype=torch.float32, device=device)
        elif name == "embed.weight":
            t = torch.empty(meta.shape, dtype=torch.float32, device=device)
            t.normal_(0.0, cfg.d_model ** -0.5, generator=gen)
        else:  # Linear weight (out, in): fan_in is the second dim
            t = torch.empty(meta.shape, dtype=torch.float32, device=device)
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
            t.mul_(meta.shape[1] ** -0.5 / _TRUNC_STD)
        params[name] = t.to(meta.dtype)
    return params
