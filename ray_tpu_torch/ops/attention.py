"""Plain attention. Port of `mha_reference` from ray_tpu/ops/attention.py.

The flash kernel of that module (and its backward) belongs to the
training slice of the port and is not here yet.
"""

from __future__ import annotations

import math

import torch

_NEG_INF = -1e30


def mha_reference(q, k, v, sm_scale: float | None = None,
                  causal: bool = False):
    """q, k, v: (B, H, S, D). f32 softmax attention; a causal mask is
    aligned top-left. Returns q's dtype."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(s.shape[-2:], dtype=torch.bool,
                          device=s.device).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
