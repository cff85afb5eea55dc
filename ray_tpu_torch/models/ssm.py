"""Selective state-space model (Mamba family). Port of
ray_tpu/models/ssm.py.

The Mamba block shape (Gu & Dao): an input projection to a gated pair, a
short depthwise causal convolution, input-selective (delta, B, C), a
diagonal A, a gated output projection. The recurrence h_t = a_t * h_{t-1}
+ b_t runs as a log-depth scan over the sequence (`_selective_scan`,
about log2(S) passes of one multiply-add each, as the reference's
associative_scan), an autograd.Function whose backward is the reverse
scan of the same recurrence and keeps only a and h. Decode is O(1) a
token: `init_ssm_state` / `ssm_decode_step` carry each layer's conv
window (d_conv - 1, E) and SSM state (E, N).

Parameter names follow the flax tree (`block.{i}.in_proj.weight` for
`block_{i}/in_proj/kernel`, `norm.{i}.scale` for `norm_{i}/scale`); the
raw parameters keep the flax layout: `conv_w` (d_conv, E), `a_log` and
`d_skip` in f32. `SSM_RULES` shard them as the reference's rules do.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.layers import ParamModel, linear
from ray_tpu_torch.models.llama import RMSNorm
from ray_tpu_torch.parallel.sharding import P, ShardingRules


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    vocab_size: int = 32000
    d_model: int = 768
    n_layers: int = 24
    d_state: int = 16          # per-channel SSM state size
    d_conv: int = 4            # depthwise conv width
    expand: int = 2            # inner width = expand * d_model
    dtype: Any = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


MAMBA_130M = SSMConfig(d_model=768, n_layers=24)
MAMBA_790M = SSMConfig(d_model=1536, n_layers=48)
TINY_SSM = SSMConfig(vocab_size=256, d_model=64, n_layers=2, d_state=8,
                     expand=2, dtype=torch.float32)


def _doubling_scan(a, b, reverse: bool = False):
    """h_t = a_t * h_{t-1} + b_t over dim 1 (from the end when reverse:
    h_t = a_t * h_{t+1} + b_t), by recursive doubling: pass d combines
    each position with the one d before it (after it), so ceil(log2 S)
    passes, each one multiply-add on h and one multiply on the running
    products of a, into a second buffer."""
    S = a.shape[1]
    h, h2 = b.clone(), torch.empty_like(b)
    prod, prod2 = a.clone(), torch.empty_like(a)
    d = 1
    while d < S:
        if reverse:   # position t takes t + d
            keep, at, src = slice(S - d, S), slice(0, S - d), slice(d, S)
        else:         # position t takes t - d
            keep, at, src = slice(0, d), slice(d, S), slice(0, S - d)
        h2[:, keep] = h[:, keep]
        torch.addcmul(h[:, at], prod[:, at], h[:, src], out=h2[:, at])
        h, h2 = h2, h
        if 2 * d < S:
            prod2[:, keep] = prod[:, keep]
            torch.mul(prod[:, at], prod[:, src], out=prod2[:, at])
            prod, prod2 = prod2, prod
        d *= 2
    return h


class _SelectiveScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        h = _doubling_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        # g_t = dL/dh_t + a_{t+1} g_{t+1}: the reverse scan over a shifted
        # by one; then da_t = g_t h_{t-1} (h_{-1} = 0) and db_t = g_t.
        a, h = ctx.saved_tensors
        a_next = torch.zeros_like(a)
        a_next[:, :-1] = a[:, 1:]
        g = _doubling_scan(a_next, dh.contiguous(), reverse=True)
        da = torch.zeros_like(a)
        torch.mul(g[:, 1:], h[:, :-1], out=da[:, 1:])
        return da, g


def _selective_scan(a, b):
    """First-order linear recurrence h_t = a_t * h_{t-1} + b_t over dim 1.
    a, b: (B, S, E, N)."""
    return _SelectiveScan.apply(a, b)


class SSMBlock(nn.Module):
    def __init__(self, cfg: SSMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, N, dt = cfg.d_inner, cfg.d_state, cfg.dtype
        self.in_proj = linear(cfg.d_model, 2 * E, dt, device)
        self.conv_w = nn.Parameter(torch.empty(cfg.d_conv, E, dtype=dt,
                                               device=device))
        self.dt_proj = linear(E, E, dt, device, bias=True)
        self.b_proj = linear(E, N, dt, device)
        self.c_proj = linear(E, N, dt, device)
        self.a_log = nn.Parameter(torch.empty(E, N, dtype=torch.float32,
                                              device=device))
        self.d_skip = nn.Parameter(torch.empty(E, dtype=torch.float32,
                                               device=device))
        self.out_proj = linear(E, cfg.d_model, dt, device)

    def forward(self, x, state=None, return_state: bool = False):
        """state=None: the parallel forward over the sequence -> y, or
        (y, final state) with return_state. state=(conv_window, h): one
        token's step (S must be 1) -> (y, new state). conv_window:
        (B, d_conv - 1, E), the last pre-conv activations; h: (B, E, N)
        f32. On DTensors (a sharded training step) the parallel forward
        only, what lies between in_proj and out_proj on each rank's rows
        (`_core_local`)."""
        if state is not None and x.shape[1] != 1:
            raise ValueError(
                f"stateful SSM step requires S==1, got S={x.shape[1]}; prime "
                "a prompt with the parallel forward (return_state=True)")
        xz = self.in_proj(x)
        weights = (self.conv_w, self.dt_proj.weight, self.dt_proj.bias,
                   self.b_proj.weight, self.c_proj.weight, self.a_log,
                   self.d_skip)
        if isinstance(xz, DTensor):
            if state is not None or return_state:
                raise NotImplementedError("the SSM's decode state on DTensors")
            return self.out_proj(_core_local(self.cfg, xz, weights))
        y, new_state = _core(self.cfg, *xz.chunk(2, dim=-1), weights, state)
        out = self.out_proj(y)
        if state is not None or return_state:
            return out, new_state
        return out


def _core(c: SSMConfig, u_in, z, weights, state=None):
    """The block between its projections: the causal depthwise conv, the
    input-selective (delta, B, C), the scan (or one step from `state`),
    the skip and the gate. Returns (y (B, S, E), the state after the
    last token)."""
    conv_w, dt_w, dt_b, b_w, c_w, a_log, d_skip = weights
    S = u_in.shape[1]
    if state is None:
        u_pad = F.pad(u_in, (0, 0, c.d_conv - 1, 0))
        window = u_pad[:, S:]        # the next step's d_conv - 1 inputs
        taps = [u_pad[:, i:i + S] for i in range(c.d_conv)]
    else:
        conv_state, h_prev = state
        window = torch.cat([conv_state, u_in], dim=1)    # (B, d_conv, E)
        taps = [window[:, i:i + 1] for i in range(c.d_conv)]
        window = window[:, 1:]
    u = taps[0] * conv_w[0]
    for i in range(1, c.d_conv):
        u = u + taps[i] * conv_w[i]
    u = F.silu(u)

    delta = F.softplus(F.linear(u, dt_w, dt_b))            # (B, S, E)
    b_sel, c_sel = F.linear(u, b_w).float(), F.linear(u, c_w).float()
    d32 = delta.float()
    decay = torch.exp(d32[..., None] * -torch.exp(a_log))  # (B, S, E, N)
    drive = (d32 * u.float())[..., None] * b_sel[:, :, None, :]
    if state is None:
        h = _selective_scan(decay, drive)
        h_last = h[:, -1]
    else:
        h_last = decay[:, 0] * h_prev + drive[:, 0]        # (B, E, N)
        h = h_last[:, None]
    y = torch.einsum("bsen,bsn->bse", h, c_sel)
    y = (y + d_skip * u.float()).to(c.dtype) * F.silu(z)
    return y, (window, h_last)


def _rows(t):
    """t, or for a DTensor t, t with only its batch dim sharded (the
    residual stream pinned to its rows). DTensor would shard the sequence
    over tp (a reduce-scatter of out_proj's partial sums), and plan the
    backward over the strided shards of the flattened tokens, for minutes
    on a mesh of three axes."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [p if p.is_shard(0) else Replicate()
                                          for p in t.placements])


def _core_local(c: SSMConfig, xz, weights):
    """_core on each rank's rows of the DTensor xz, in_proj's output (the
    batch as it is sharded; the sequence and the channels whole, split
    into u_in and z there), the block's weights gathered, their local
    grads partial over the axes that shard the rows. DTensor's own
    propagation (the split of the tp-sharded channels, b_proj's over
    fsdp) re-shards the sequence and plans its backward over strided
    shards for minutes on a mesh of three axes."""
    rows = [p if p.is_shard(0) else Replicate() for p in xz.placements]
    whole = [Replicate()] * len(rows)
    partial = [Partial() if p.is_shard() else Replicate() for p in rows]
    return local_map(
        lambda xz, *w: _core(c, *xz.chunk(2, dim=-1), w)[0],
        out_placements=rows, in_placements=(rows,) + (whole,) * len(weights),
        in_grad_placements=(rows,) + (partial,) * len(weights),
        device_mesh=xz.device_mesh, redistribute_inputs=True,
    )(xz, *weights)


class SSMModel(ParamModel):
    """Decoder-only SSM language model (Mamba-style residual stack)."""

    raw_init = {r"\.conv_w$": ("normal", 0.02),
                r"\.a_log$": ("normal", 0.5),
                r"\.d_skip$": ("ones",)}

    def __init__(self, cfg: SSMConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                      dtype=cfg.dtype, device=device)
        self.norm = nn.ModuleList(RMSNorm(cfg.d_model, 1e-5, device)
                                  for _ in range(cfg.n_layers))
        self.block = nn.ModuleList(SSMBlock(cfg, device)
                                   for _ in range(cfg.n_layers))
        self.norm_f = RMSNorm(cfg.d_model, 1e-5, device)

    def forward(self, tokens, states=None, return_states: bool = False):
        """states=None: (B, S) -> (B, S, V) logits; with return_states ->
        (logits, states), the parallel prefill that primes the decode.
        states=[per layer (conv_window, h)]: (B, 1) one token -> (logits
        (B, 1, V), new states). Logits are in cfg.dtype, as the
        reference's tied embedding gives them."""
        c = self.cfg
        x = _rows(self.tok_embed(tokens))
        new_states = []
        for i, (norm, block) in enumerate(zip(self.norm, self.block)):
            h = norm(x).to(c.dtype)
            if states is not None:
                y, st = block(h, states[i])
            elif return_states:
                y, st = block(h, return_state=True)
            else:
                y, st = block(h), None
            x = x + _rows(y)
            if st is not None:
                new_states.append(st)
        logits = self.norm_f(x).to(c.dtype) @ self.tok_embed.weight.T
        if states is None and not return_states:
            return logits
        return logits, new_states


# Mesh sharding rules, the reference's: TP shards the inner channel dim E,
# FSDP the other matrix dim; the small d_state axis stays replicated.
SSM_RULES = ShardingRules([
    (r"tok_embed/embedding", P("fsdp", "tp")),
    (r"in_proj/kernel", P("fsdp", "tp")),
    (r"out_proj/kernel", P("tp", "fsdp")),
    (r"dt_proj/kernel", P("fsdp", "tp")),
    (r"(b_proj|c_proj)/kernel", P("fsdp", None)),
    (r"conv_w", P(None, "tp")),
    (r"a_log", P("tp", None)),
    (r"d_skip", P("tp")),
    (r"(norm|scale|bias)", P()),
], default=P())


def init_ssm_state(cfg: SSMConfig, batch: int, device=None):
    """A fresh per-layer decode state on `device` (None means CUDA), all
    zeros: the conv window in cfg.dtype and the SSM state in f32 (O(1) in
    the sequence length)."""
    device = resolve_device(device)
    E, N = cfg.d_inner, cfg.d_state
    return [(torch.zeros((batch, cfg.d_conv - 1, E), dtype=cfg.dtype,
                         device=device),
             torch.zeros((batch, E, N), dtype=torch.float32, device=device))
            for _ in range(cfg.n_layers)]


def ssm_prefill(model: SSMModel, tokens):
    """Primes the decode state from a prompt in one parallel forward:
    tokens (B, S) -> (last logits (B, V), states)."""
    logits, states = model(tokens, return_states=True)
    return logits[:, -1], states


def ssm_decode_step(model: SSMModel, token, states):
    """One O(1) decode step: token (B,) -> (logits (B, V), new states)."""
    logits, new_states = model(token[:, None], states)
    return logits[:, 0], new_states
