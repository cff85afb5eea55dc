"""What the port's models share with flax.linen's defaults.

`ParamModel` loads a state_dict without copying it (`from_params`) and
makes the buffers that are computed rather than loaded (`_set_buffers`).
`LayerNorm` is flax's: computed in f32, epsilon 1e-6 (torch's default is
1e-5), an f32 scale and bias that either flag leaves out; on a DTensor it
runs on each rank's rows. `gelu` is
flax's and jax's default, the tanh approximation. `linear` is a flax
Dense as an nn.Linear: a weight (out, in) and, where the Dense has one,
a bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map


class ParamModel(nn.Module):
    """Base of the port's models. The parameters are named after the flax
    tree (`models/convert.py` maps one onto the other); `raw_init` maps a
    regex over their names to the initializer flax gives them where it
    is not a Dense's, an Embed's or a norm's default: ("zeros",),
    ("ones",) or ("normal", std)."""

    raw_init: dict = {}

    def _set_buffers(self, device) -> None:
        """Makes the non-persistent buffers on `device`; none here."""

    @classmethod
    def from_params(cls, cfg, params: dict, device: torch.device,
                    trainable: bool = False):
        """A model that holds `params` (a state_dict, as init_params or
        params_from_flax give it) on `device`, without a second copy of
        tensors already there: two models loaded from one dict share their
        tensors. For inference by default; `trainable=True` gives
        parameters that require grad, in train mode."""
        model = cls(cfg, device="meta")
        expected = model.state_dict()
        model.load_state_dict(
            {k: v.to(device=device, dtype=expected[k].dtype)
             if k in expected else v for k, v in params.items()},
            strict=True, assign=True)
        model._set_buffers(device)
        return model.requires_grad_(trainable).train(trainable)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm(dtype=float32): the output is f32 whatever
    the input's type."""

    def __init__(self, dim: int, eps: float = 1e-6, use_scale: bool = True,
                 use_bias: bool = True, device=None):
        super().__init__()
        self.dim, self.eps = dim, eps
        f32 = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(dim, **f32)) \
            if use_scale else None
        self.bias = nn.Parameter(torch.zeros(dim, **f32)) \
            if use_bias else None

    def forward(self, x):
        if isinstance(x, DTensor):
            return _layer_norm_local(x, self.scale, self.bias, self.eps)
        return F.layer_norm(x.float(), (self.dim,), self.scale, self.bias,
                            self.eps)


def _layer_norm_local(x, scale, bias, eps: float):
    """F.layer_norm on each rank's rows of a DTensor x, the normalized dim
    whole (gathered if sharded), the scale and bias replicated with their
    local grads partial over the axes that shard the rows. DTensor's own
    propagation may shard the sequence instead (an all-to-all), which
    flattens into strided shards whose backward plans took minutes on a
    mesh of three axes."""
    last = x.ndim - 1
    rows = [Replicate() if p.is_partial() or (p.is_shard() and p.dim in
                                              (-1, last)) else p
            for p in x.placements]
    whole = [Replicate()] * len(rows)
    partial = [Partial() if p.is_shard() else Replicate() for p in rows]
    params = [(t, whole, partial) for t in (scale, bias) if t is not None]

    def fn(t, *wb):
        it = iter(wb)
        w = next(it) if scale is not None else None
        b = next(it) if bias is not None else None
        return F.layer_norm(t.float(), (t.shape[-1],), w, b, eps)

    return local_map(
        fn, out_placements=rows,
        in_placements=(rows,) + tuple(p for _, p, _ in params),
        in_grad_placements=(rows,) + tuple(g for _, _, g in params),
        device_mesh=x.device_mesh, redistribute_inputs=True,
    )(x, *(t for t, _, _ in params))


def gelu(x):
    return F.gelu(x, approximate="tanh")


def linear(d_in: int, d_out: int, dtype, device=None,
           bias: bool = False) -> nn.Linear:
    return nn.Linear(d_in, d_out, bias=bias, dtype=dtype, device=device)
