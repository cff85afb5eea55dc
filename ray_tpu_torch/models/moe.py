"""Mixture-of-Experts decoder (Mixtral-style). Port of ray_tpu/models/moe.py.

The reference's design, kept here: routing is capacity-bounded and
static-shape, with one-hot dispatch and combine tensors of shape (tokens,
experts, slots); the expert FFNs are batched products over a leading
expert dim; and expert parallelism is a layout, not message passing: the
expert weights' leading dim is sharded over the mesh axis `ep`
(`MOE_RULES`), and the layout's collectives come from DTensor's sharding
propagation, as they come from GSPMD in the reference.

The capacity C and the slot order are those of the whole batch: C counts
every token of the global batch, and each expert's slots fill in the
flat k-major order of all tokens (every first choice before any second
one). On a mesh that shards the batch, `route` runs on each rank's tokens
(`local_map`) and adds to its own running counts the choices of the data
ranks before it, which it all-gathers; a capacity per shard would drop
other tokens. The dispatch and combine products run on each rank's
shards too (`_expert_parallel`: DTensor's own propagation over their
merged, sharded dims took minutes on a 3-axis mesh), and the expert FFNs
are DTensor products.

Parameter names follow the flax tree, as the Llama's do: the router is a
Linear (`layers.{i}.moe.router.weight`, f32 in every model, as the
reference keeps it), the experts are raw (E, in, out) parameters in the
flax layout (`layers.{i}.moe.w_gate`, `w_up`, `w_down`).

The reference sows each layer's load-balancing loss into flax's
"intermediates"; here `MoEModel.forward` fills a dict the caller passes
(`intermediates`), keyed by flax path (`layers_0/moe/moe_aux_loss`, and
the layer's routing under `layers_0/moe/routing`), and `moe_aux_loss`
sums the losses.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.models.llama import Attention, DecoderModel, RMSNorm
from ray_tpu_torch.parallel.sharding import P, ShardingRules, spec_placements
from ray_tpu_torch.util.collective import ops as col


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: Any = torch.bfloat16
    attention: str = "flash"  # "flash" | "ring" | "reference"
    remat: bool = True        # recompute each layer in the backward

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


MIXTRAL_8X7B = MoEConfig()
TINY_MOE = MoEConfig(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                     n_kv_heads=4, d_ff=128, n_experts=4, experts_per_token=2,
                     max_seq_len=128, dtype=torch.float32,
                     attention="reference", remat=False)

# The reference's MoEAttention is the Llama's attention without a cache:
# the same projections, RoPE, GQA repeat and flash/ring/reference branches.
MoEAttention = Attention

_DATA_AXES = ("dp", "fsdp")


def _choices_before_and_total(counts, mesh):
    """(the choices of the data ranks before this one, those of every
    rank), each (K, E), from this rank's counts: all-gathered over the
    mesh's data axes, ranks in the batch's shard order (dp major)."""
    axes = [a for a in _DATA_AXES if mesh is not None
            and a in mesh.mesh_dim_names]
    if not axes:
        return torch.zeros_like(counts), counts
    with col.mesh_context(mesh):
        every = counts
        for a in reversed(axes):             # minor axis first
            every = col.allgather(every, a)  # stacked in a new dim 0
        me = 0
        for a in axes:
            me = me * col.axis_size(a) + col.axis_index(a)
    every = every.reshape(-1, *counts.shape)
    return every[:me].sum(0), every.sum(0)


def route(probs, k: int, capacity: int, mesh=None):
    """Top-k routing with a capacity, as the reference's MoEMLP routes.

    probs: (G, E) router probabilities of this rank's tokens (all of them
    off a mesh; on one, this rank's shard of the batch, the data ranks
    found on `mesh`). Returns (top_e (G, K), slot (G, K) int32, keep
    (G, K), dispatch (G, E, C), combine (G, E, C), f_e (E,)): each
    choice's expert and its slot in that expert's queue, whether the slot
    is below the capacity, the one-hot dispatch, the dispatch weighted by
    the renormalized gate probabilities, and each expert's share of all
    choices of the global batch, dropped or not."""
    E = probs.shape[-1]
    top_p, top_e = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    e_onehot = F.one_hot(top_e, E).float()                  # (G, K, E)
    before, total = _choices_before_and_total(e_onehot.sum(0), mesh)
    # k-major priority: every k=0 choice of the batch fills before any
    # k=1 choice; within one k, tokens in order, ranks in order.
    base = total.cumsum(0) - total + before                 # (K, E)
    pos = e_onehot.cumsum(0) - e_onehot + base              # (G, K, E)
    slot = (pos * e_onehot).sum(-1).to(torch.int32)
    keep = (slot < capacity).float()
    # zero rows for dropped choices, as jax.nn.one_hot gives out of range
    slot_oh = (slot[..., None] == torch.arange(
        capacity, device=slot.device)).float()              # (G, K, C)
    dispatch = torch.einsum("gke,gkc->gec", e_onehot, slot_oh)
    gates = torch.einsum("gke,gk->ge", e_onehot, top_p * keep)
    combine = dispatch * gates[..., None]
    f_e = total.sum(0) / total.sum()
    return top_e, slot, keep, dispatch, combine, f_e


def _dispatch(dispatch, xf):
    """The tokens in their experts' slots: (E, C, M), in f32."""
    return torch.einsum("gec,gm->ecm", dispatch, xf)


def _combine(combine, out_e):
    """Each token's experts' outputs weighted by its gates: (G, M)."""
    return torch.einsum("gec,ecm->gm", combine, out_e)


def _on(mesh, data=None, ep=None, tp=None) -> list:
    """Placements on `mesh`: `data` on dp and fsdp, `ep` on ep, `tp` on tp,
    Replicate where None and on the other axes."""
    by_axis = {"dp": data, "fsdp": data, "ep": ep, "tp": tp}
    return [by_axis.get(a) or Replicate() for a in mesh.mesh_dim_names]


def _expert_parallel(mesh, k: int, capacity: int):
    """(route, _dispatch, _combine) on each rank's shards of DTensors on
    `mesh`, as GSPMD partitions the reference's einsums: the routing on
    the rank's tokens (the batch over the data axes); the dispatch of
    those tokens to its experts (ep) and its slice of d_model (tp),
    partial sums over the data ranks; the combine of its experts' outputs,
    partial over ep, and over tp where out_e holds partial sums of its
    d_ff slices. Each `in_grad_placements` says what a rank's local
    gradient is: a partial sum where the rank saw only its experts,
    slice or tokens."""
    tokens = _on(mesh, data=Shard(0))
    # out_placements: a list for one output, a tuple of lists for several
    fn = functools.partial(local_map, device_mesh=mesh,
                           redistribute_inputs=True)
    routed = fn(functools.partial(route, k=k, capacity=capacity, mesh=mesh),
                out_placements=(tokens,) * 5 + (_on(mesh),),
                in_placements=(tokens,))
    by_expert = _on(mesh, data=Shard(0), ep=Shard(1))
    dispatch = fn(
        _dispatch,
        out_placements=_on(mesh, data=Partial(), ep=Shard(0), tp=Shard(2)),
        in_placements=(by_expert, _on(mesh, data=Shard(0), tp=Shard(1))),
        in_grad_placements=(by_expert, _on(mesh, data=Shard(0), ep=Partial(),
                                           tp=Shard(1))))
    combine = fn(
        _combine,
        out_placements=_on(mesh, data=Shard(0), ep=Partial(), tp=Partial()),
        in_placements=(by_expert, _on(mesh, ep=Shard(0), tp=Partial())),
        in_grad_placements=(_on(mesh, data=Shard(0), ep=Shard(1),
                                tp=Partial()),
                            _on(mesh, data=Partial(), ep=Shard(0))))
    return routed, dispatch, combine


def _constrain_experts(t):
    """The reference's with_sharding_constraint(P("ep", None, "tp")) on the
    dispatched tokens (E, C, M), in f32: on a DTensor, the data ranks'
    partial dispatches summed, the experts over ep and d_model over tp."""
    if not isinstance(t, DTensor):
        return t
    want = spec_placements(P("ep", None, "tp"), t.device_mesh)
    return t if tuple(t.placements) == want \
        else t.redistribute(t.device_mesh, want)


def _sum_partials(t):
    """t with the partial sums of a DTensor reduced, in t's dtype."""
    if not isinstance(t, DTensor):
        return t
    want = [Replicate() if isinstance(p, Partial) else p
            for p in t.placements]
    return t.redistribute(t.device_mesh, want)


class MoEMLP(nn.Module):
    """Top-k routed SwiGLU experts with capacity-bounded dense dispatch."""

    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.cfg = cfg
        E, M, Fh = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Linear(M, E, bias=False, dtype=torch.float32,
                                device=device)

        def experts(*shape):
            return nn.Parameter(torch.empty(shape, dtype=cfg.dtype,
                                            device=device))

        self.w_gate, self.w_up = experts(E, M, Fh), experts(E, M, Fh)
        self.w_down = experts(E, Fh, M)

    def forward(self, x):
        """x: (B, S, M). Returns (out (B, S, M), the aux loss, the routing
        {"top_e", "slot", "keep", "probs"}: see `route`, and the router's
        probabilities)."""
        cfg = self.cfg
        B, S, M = x.shape
        E, K = cfg.n_experts, cfg.experts_per_token
        G = B * S
        # Per-expert slot budget over the global batch; tokens routed past
        # it are dropped (their residual stream passes through unchanged).
        C = max(1, int(cfg.capacity_factor * G * K / E))
        xf = x.reshape(G, M).float()
        probs = torch.softmax(self.router(xf), dim=-1)       # (G, E)
        if isinstance(probs, DTensor):
            routed, dispatch_fn, combine_fn = _expert_parallel(
                probs.device_mesh, K, C)
        else:
            routed = functools.partial(route, k=K, capacity=C)
            dispatch_fn, combine_fn = _dispatch, _combine
        top_e, slot, keep, dispatch, combine, f_e = routed(probs)
        # Load-balance aux loss (Switch eq. 4): E * sum_e f_e * p_e.
        aux = E * (f_e * probs.mean(0)).sum() * cfg.aux_loss_coef

        expert_in = _constrain_experts(dispatch_fn(dispatch, xf)).to(
            cfg.dtype)
        # Batched expert FFN (SwiGLU), leading expert dim sharded over ep.
        h = torch.einsum("ecm,emf->ecf", expert_in, self.w_gate)
        u = torch.einsum("ecm,emf->ecf", expert_in, self.w_up)
        out_e = torch.einsum("ecf,efm->ecm", F.silu(h) * u, self.w_down)
        out = _sum_partials(combine_fn(combine, out_e.float())).to(cfg.dtype)
        return out.reshape(B, S, M), aux, {
            "top_e": top_e, "slot": slot, "keep": keep,
            "probs": probs.detach()}


class MoEDecoderLayer(nn.Module):
    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        self.input_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.attn = MoEAttention(cfg, device)
        self.post_attn_norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.moe = MoEMLP(cfg, device)

    def forward(self, x, positions, rope):
        x = x + self.attn(self.input_norm(x), positions, rope)
        out, aux, routing = self.moe(self.post_attn_norm(x))
        return x + out, aux, routing


class MoEModel(DecoderModel):
    def __init__(self, cfg: MoEConfig, device=None):
        super().__init__()
        if cfg.attention not in ("flash", "ring", "reference"):
            raise ValueError(f"attention {cfg.attention!r}: the MoE model "
                             "takes 'flash', 'ring' or 'reference'")
        self.cfg = cfg
        self.embed = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                  dtype=cfg.dtype, device=device)
        self.layers = nn.ModuleList(
            MoEDecoderLayer(cfg, device) for _ in range(cfg.n_layers))
        self.norm = RMSNorm(cfg.d_model, cfg.rms_eps, device)
        self.lm_head = nn.Linear(cfg.d_model, cfg.vocab_size, bias=False,
                                 dtype=cfg.dtype, device=device)
        self._set_buffers(device)

    def forward(self, tokens, positions=None, intermediates=None):
        """Logits (B, S, vocab) in f32. `intermediates`, a dict, receives
        each layer's aux loss and routing (see the module's docstring).
        `cfg.remat` recomputes each layer in the backward, saving nothing
        inside it (the reference's nothing_saveable)."""
        rope = (self.rope_cos, self.rope_sin)
        x = self.embed(tokens)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for i, layer in enumerate(self.layers):
            if remat:
                x, aux, routing = checkpoint(layer, x, positions, rope,
                                             use_reentrant=False)
            else:
                x, aux, routing = layer(x, positions, rope)
            if intermediates is not None:
                intermediates[f"layers_{i}/moe/moe_aux_loss"] = aux
                intermediates[f"layers_{i}/moe/routing"] = routing
        return self.lm_head(self.norm(x)).float()


def moe_aux_loss(intermediates: dict):
    """The sum of the per-layer aux losses a forward put in
    `intermediates` (0 where there are none)."""
    losses = [v for k, v in intermediates.items()
              if k.endswith("/moe_aux_loss")]
    if not losses:
        return torch.tensor(0.0)
    return sum(loss.float() for loss in losses)


# Sharding rules: transformer rules + expert weights sharded over ep (and
# tp/fsdp inside each expert). The router stays replicated.
MOE_RULES = ShardingRules([
    (r"embed/embedding", P("fsdp", "tp")),
    (r"(q_proj|k_proj|v_proj)/kernel", P("fsdp", "tp")),
    (r"o_proj/kernel", P("tp", "fsdp")),
    (r"router/kernel", P()),
    (r"(w_gate|w_up)$", P("ep", "fsdp", "tp")),
    (r"w_down$", P("ep", "tp", "fsdp")),
    (r"lm_head/kernel", P("fsdp", "tp")),
    (r"(norm|ln|scale|bias)", P()),
], default=P())


def count_flops_per_token(cfg: MoEConfig) -> float:
    """Active-parameter forward+backward FLOPs per token."""
    attn = (cfg.d_model * cfg.head_dim * (cfg.n_heads + 2 * cfg.n_kv_heads)
            + cfg.n_heads * cfg.head_dim * cfg.d_model)
    ffn_active = cfg.experts_per_token * 3 * cfg.d_model * cfg.d_ff
    n = (2 * cfg.vocab_size * cfg.d_model
         + cfg.n_layers * (attn + ffn_active))
    return 6.0 * n
