"""Attention: flash attention (forward and backward) and plain attention.

Port of ray_tpu/ops/attention.py. The Pallas forward `_flash_fwd_kernel`
and the blockwise `lax.scan` backward become one CUDA source,
`csrc/flash_attention.cu`: a forward kernel, and a backward of a dK/dV
kernel and a dQ kernel (with a small pre-pass for delta). bf16 inputs with
head dims up to 128 run on wgmma with TMA loads, forward and backward (so
their inputs must suit TMA, see `tma_layout_problem`); f32 inputs run
exact f32 FMAs.
`flash_attention` is a `torch.autograd.Function` over them, as the JAX
function is a `custom_vjp` whose residuals are (q, k, v, out, lse).

Each kernel has a plain PyTorch version (`flash_forward_reference`,
`flash_backward_reference`) that follows the JAX computation step by
step: the forward's blocks and online softmax with the same guards, the
backward's scan over q blocks. `_flash_forward` and `_flash_backward`
run the plain version for tensors on the CPU and launch the kernels for
tensors on a CUDA device, raising on anything the kernels do not take.
`launch_counts` counts kernel launches per wrapper.

`ring_attention` and `ulysses_attention` are sequence parallelism over a
mesh axis: on each rank's shard of the sequence inside `mesh_context`, as
the reference runs them inside shard_map. Ring attention runs plain f32
products, as the reference's einsums do; Ulysses runs `flash_attention` on
the card and `mha_reference` on the CPU, as the reference does off-TPU.

On DTensors (a sharded training step) each of the three, and
`mha_reference`, runs on the local
shards through `local_map`: the batch sharded over dp and fsdp and the
heads over tp, as TRANSFORMER_RULES and batch_spec lay them out; the
sequence stays sharded over sp for ring and Ulysses and is gathered first
for flash attention, as GSPMD would gather it.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ray_tpu_torch import _build
from ray_tpu_torch.util.collective import ops as col

_NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches by wrapper; only a CUDA launch adds to a count.
launch_counts = {
    "flash_attention_forward": 0,
    "flash_attention_backward": 0,
}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _kernels():
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_fwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                  i32, i32, i32, i32, i32, f32, i32, i32, ptr]
        lib.flash_fwd.restype = i32
        lib.flash_bwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                  ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32,
                                  f32, i32, i32, ptr]
        lib.flash_bwd.restype = i32
        lib.flash_bwd_scratch_floats.argtypes = [i32, i32, i32, i32, i32]
        lib.flash_bwd_scratch_floats.restype = ctypes.c_longlong
        lib.flash_error_string.argtypes = [i32]
        lib.flash_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _scale(q, sm_scale):
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def mha_reference(q, k, v, sm_scale: float | None = None,
                  causal: bool = False):
    """q, k, v: (B, H, S, D). f32 softmax attention; a causal mask is
    aligned top-left. Returns q's dtype. DTensors run on each rank's heads
    and batch shard, as flash_attention does."""
    if isinstance(q, DTensor):
        return _on_local_shards(functools.partial(
            mha_reference, sm_scale=sm_scale, causal=causal), q, k, v)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) \
        * _scale(q, sm_scale)
    if causal:
        mask = s.new_ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def _fit_block(block: int, seq: int) -> int:
    """The Pallas wrapper's block rule: the largest block <= the request
    that divides the sequence, halving first; a prime length is one block."""
    block = min(block, seq)
    while block > 1 and seq % block:
        block //= 2
    if seq % block:
        block = seq
    return block


def flash_forward_reference(q, k, v, sm_scale: float, causal: bool,
                            block_q: int, block_k: int,
                            kv_valid_len: int | None = None):
    """The Pallas forward's arithmetic, block by block: for each q block,
    an online softmax over the k blocks it needs, with the kernel's -1e30
    guards, p rounded to v's dtype before P.V, and lse = -1e30 for rows
    with no visible key. Returns (out in q's dtype, lse (B, H, Sq) f32)."""
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    bq, bk = _fit_block(block_q, Sq), _fit_block(block_k, Sk)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    masked = _NEG_INF / 2
    for qs in range(0, Sq, bq):
        qb = q[:, :, qs:qs + bq].float()
        m = torch.full((B, H, bq, 1), _NEG_INF, device=q.device)
        l = torch.zeros((B, H, bq, 1), device=q.device)
        acc = torch.zeros((B, H, bq, D), device=q.device)
        for ks in range(0, Sk, bk):
            if causal and ks > qs + bq - 1:
                continue  # wholly above the diagonal: skipped
            kb = k[:, :, ks:ks + bk].float()
            vb = v[:, :, ks:ks + bk]
            s = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * sm_scale
            q_pos = qs + torch.arange(bq, device=q.device)[:, None]
            k_pos = ks + torch.arange(bk, device=q.device)[None, :]
            if causal:
                s = torch.where(q_pos >= k_pos, s, _NEG_INF)
            if kv_valid_len is not None and kv_valid_len < Sk:
                s = torch.where(k_pos < kv_valid_len, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            m_safe = torch.where(m_new <= masked, 0.0, m_new)
            p = torch.exp(torch.where(s <= masked, -math.inf, s - m_safe))
            alpha = torch.exp(torch.where(m <= masked, -math.inf,
                                          m - m_safe))
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum(
                "bhqk,bhkd->bhqd", p.to(v.dtype).float(), vb.float())
            m = m_new
        l_safe = torch.where(l == 0.0, 1.0, l)
        out[:, :, qs:qs + bq] = (acc / l_safe).to(q.dtype)
        lse[:, :, qs:qs + bq] = torch.where(
            l == 0.0, _NEG_INF, m + torch.log(l_safe))[..., 0]
    return out, lse


def flash_backward_reference(sm_scale, causal, block_q, block_k,
                             kv_valid_len, res, do):
    """The JAX backward line by line: a loop over q blocks that rebuilds P
    from the saved lse (no guards), dV += P^T dO with P rounded to v's
    dtype, dS = P (dO V^T - delta) * scale rounded to v's dtype, dQ = dS K
    per block, dK += dS^T Q; f32 sums. Returns (dq, dk, dv) in the input
    dtypes."""
    q, k, v, out, lse = res
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    delta = torch.einsum("bhsd,bhsd->bhs", out.float(), do.float())
    bq = min(block_q, Sq)
    if Sq % bq:
        bq = Sq
    kf, vf = k.float(), v.float()
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for qs in range(0, Sq, bq):
        q_blk = q[:, :, qs:qs + bq].float()
        do_blk = do[:, :, qs:qs + bq].float()
        s = torch.einsum("bhqd,bhkd->bhqk", q_blk, kf) * sm_scale
        if causal:
            q_pos = qs + torch.arange(bq, device=q.device)[:, None]
            s = torch.where(q_pos >= k_pos, s, _NEG_INF)
        if kv_valid_len is not None and kv_valid_len < Sk:
            s = torch.where(k_pos < kv_valid_len, s, _NEG_INF)
        p = torch.exp(s - lse[:, :, qs:qs + bq, None])
        dv += torch.einsum("bhqk,bhqd->bhkd", p.to(v.dtype).float(), do_blk)
        dp = torch.einsum("bhqd,bhkd->bhqk", do_blk, vf)
        ds = (p * (dp - delta[:, :, qs:qs + bq, None]) * sm_scale).to(v.dtype)
        ds = ds.float()
        dq[:, :, qs:qs + bq] = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, q_blk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def tma_layout_problem(t) -> str | None:
    """Why TMA cannot load the (B, H, S, D) tensor t, or None if it can.

    TMA takes a base aligned to 16 bytes and strides that are nonzero
    multiples of 16 bytes. A dim of size 1 is never stepped over, so its
    stride does not matter. A contiguous tensor with D % 8 == 0 suits,
    and so do the model's (B, S, H, D) projections seen as (B, H, S, D);
    an expanded tensor (a zero stride) does not."""
    if t.data_ptr() % 16:
        return (f"its data starts {t.data_ptr() % 16} bytes past a 16-byte "
                "boundary")
    item = t.element_size()
    for name, size, stride in zip(("batch", "head", "seq"), t.shape[:3],
                                  t.stride()[:3]):
        if size > 1 and stride == 0:
            return f"its {name} stride is 0 (an expanded tensor)"
        if size > 1 and stride * item % 16:
            return (f"its {name} stride of {stride} elements is not a "
                    "multiple of 16 bytes")
    return None


def grad_for_kernels(do):
    """The output's gradient as the backward kernels take it: `do` itself
    where its last dim is contiguous and TMA can load it, else a
    contiguous copy in a new allocation. Autograd chooses this layout (an
    expanded gradient, the backward of a sum, has zero strides), so the
    autograd function copies; `_flash_backward`, called with a layout of
    the caller's choosing, refuses one that does not suit."""
    if do.stride(-1) != 1 or tma_layout_problem(do):
        # a fresh allocation: .contiguous() keeps a misaligned base
        return do.clone(memory_format=torch.contiguous_format)
    return do


def _check(q, k, v, kv_valid_len, more=()):
    """Raises unless the kernels take these tensors; returns kv_len. With
    bf16 and D <= 128 every tensor is held to the TMA rule (the kernels
    load q, k, v and do through TMA)."""
    if q.device.type != "cuda":
        raise ValueError(
            f"flash attention kernel needs CUDA or CPU tensors, got {q.device}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q, k, v must be (B, H, S, D) with k and v alike, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    if k.shape[:2] != (B, H) or k.shape[3] != D:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch, heads or head dim")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported dtype {q.dtype}; the kernels take "
                         "float32 and bfloat16")
    named = (("k", k), ("v", v)) + tuple(more)
    for name, t in named:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
    if not 16 <= D <= 256 or D % 8:
        raise ValueError(f"head dim {D} out of the kernels' range "
                         "(16-256, a multiple of 8)")
    for name, t in (("q", q),) + named:
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
        problem = tma_layout_problem(t) \
            if q.dtype == torch.bfloat16 and D <= 128 else None
        if problem:
            raise ValueError(f"{name} does not suit the kernels' TMA loads: "
                             f"{problem} (.contiguous() makes it suit)")
    Sk = k.shape[2]
    if Sq < 1 or Sk < 1:
        raise ValueError("empty sequence")
    kv_len = Sk if kv_valid_len is None else min(int(kv_valid_len), Sk)
    if kv_len < 1:
        raise ValueError(f"kv_valid_len {kv_valid_len} leaves no key: the "
                         "kernels need at least one")
    return kv_len


def _strides(*tensors):
    flat = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _raise_on(lib, err, what):
    if err:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           + lib.flash_error_string(err).decode())


def _flash_forward(q, k, v, sm_scale: float, causal: bool,
                   block_q: int, block_k: int,
                   kv_valid_len: int | None = None):
    """(out, lse (B, H, Sq) f32) for q (B, H, Sq, D), k and v (B, H, Sk, D).

    The kernel takes (batch, head, seq) strides, so inputs need only a
    contiguous last dim (the model hands q, k and v over as transposed
    views).
    Its tiles are its own: block_q and block_k set only the plain
    version's blocks, which change nothing but the order of f32 sums.
    bf16 with D <= 128 loads through TMA, which bounds the layout
    (`tma_layout_problem`). Every kernel takes any scale."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, sm_scale, causal, block_q,
                                       block_k, kv_valid_len)
    kv_len = _check(q, k, v, kv_valid_len)
    B, H, Sq, D = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _kernels()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            _strides(q, k, v), out.data_ptr(), lse.data_ptr(), B, H, Sq,
            k.shape[2], D, float(sm_scale), int(causal), kv_len,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "forward")
    launch_counts["flash_attention_forward"] += 1
    return out, lse


def _flash_backward(sm_scale, causal, block_q, block_k, kv_valid_len, res,
                    do):
    """(dq, dk, dv) from the residuals res = (q, k, v, out, lse) and the
    output's gradient do, as the JAX `_flash_backward` takes them. Like
    the forward, the kernels take (batch, head, seq) strides; bf16 with
    D <= 128 loads q, k, v and do through TMA and raises ValueError on a
    layout that does not suit it (`tma_layout_problem`): the caller
    chose the layout, so nothing is copied here (`grad_for_kernels`
    makes autograd's gradient suit)."""
    q, k, v, out, lse = res
    if q.device.type == "cpu":
        return flash_backward_reference(sm_scale, causal, block_q, block_k,
                                        kv_valid_len, res, do)
    kv_len = _check(q, k, v, kv_valid_len, (("out", out), ("do", do)))
    B, H, Sq, D = q.shape
    Sk = k.shape[2]
    if out.shape != q.shape or do.shape != q.shape \
            or lse.shape != (B, H, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("out and do must be shaped as q, and lse a "
                         "contiguous (B, H, Sq) float32 tensor on q's device")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    lib = _kernels()
    delta = torch.empty(lib.flash_bwd_scratch_floats(
        _DTYPE_CODES[q.dtype], B, H, Sq, D), dtype=torch.float32,
        device=q.device)
    with torch.cuda.device(q.device):
        err = lib.flash_bwd(
            _DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), do.data_ptr(), _strides(q, k, v, out, do),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), B, H, Sq, Sk, D, float(sm_scale), int(causal),
            kv_len, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "backward")
    launch_counts["flash_attention_backward"] += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, causal, block_q, block_k):
        scale = _scale(q, sm_scale)
        out, lse = _flash_forward(q, k, v, scale, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        scale, causal, block_q, block_k = ctx.args
        dq, dk, dv = _flash_backward(scale, causal, block_q, block_k, None,
                                     ctx.saved_tensors, grad_for_kernels(do))
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, sm_scale: float | None = None,
                    causal: bool = False, block_q: int = 512,
                    block_k: int = 512):
    """Flash attention. q, k, v: (batch, heads, seq, head_dim); causal
    masking is aligned top-left. Differentiable in q, k and v; the
    backward recomputes P from the saved logsumexp. DTensors run on each
    rank's heads and batch shard (see the module's docstring)."""
    if isinstance(q, DTensor):
        return _on_local_shards(functools.partial(
            flash_attention, sm_scale=sm_scale, causal=causal,
            block_q=block_q, block_k=block_k), q, k, v)
    return _FlashAttention.apply(q, k, v, sm_scale, causal, block_q, block_k)


def _on_local_shards(fn, q, k, v, seq_axis: str | None = None):
    """fn(q, k, v) -> out on the local shards of DTensors (B, H, S, D):
    batch on dp and fsdp, heads on tp, the sequence on seq_axis or
    gathered; out is laid out as its inputs."""
    mesh = q.device_mesh
    shard = {"dp": 0, "fsdp": 0, "tp": 1, seq_axis: 2}
    # a list: local_map reads a tuple of placements as one per output
    layout = [Shard(shard[a]) if a in shard else Replicate()
              for a in mesh.mesh_dim_names]
    return local_map(fn, out_placements=layout, in_placements=(layout,) * 3,
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _collective_mesh(q):
    """The mesh whose axes a DTensor attention's collectives name: the
    current one (a sharded step sets the full mesh), else q's."""
    mesh = col.current_mesh()
    return q.device_mesh if mesh is None else mesh


def ring_attention(q, k, v, axis: str = "sp", *, causal: bool = False,
                   sm_scale: float | None = None):
    """Exact attention over a sequence sharded on a mesh axis.

    q, k, v: this rank's sequence chunk, (B, H, S/n, D), chunks in axis
    order. K and V rotate n-1 times around the ring (`permute`); an online
    softmax in f32 merges each chunk's scores, and the causal mask comes
    from the chunks' global positions. Differentiable: the rotations'
    gradients go back around the ring. Runs inside mesh_context, or on
    DTensors (the collectives then use the current mesh, else theirs).
    """
    if isinstance(q, DTensor):
        with col.mesh_context(_collective_mesh(q)):
            return _on_local_shards(functools.partial(
                ring_attention, axis=axis, causal=causal, sm_scale=sm_scale),
                q, k, v, seq_axis=axis)
    n = col.axis_size(axis)
    me = col.axis_index(axis)
    scale = _scale(q, sm_scale)
    B, H, S, D = q.shape
    perm = [(i, (i + 1) % n) for i in range(n)]
    masked = _NEG_INF / 2
    q32 = q.float()
    acc = torch.zeros((B, H, S, D), dtype=torch.float32, device=q.device)
    m_run = torch.full((B, H, S, 1), _NEG_INF, device=q.device)
    l_run = torch.zeros((B, H, S, 1), device=q.device)
    pos = torch.arange(S, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        k_idx = (me - i) % n       # the global chunk held on this step
        s = torch.einsum("bhqd,bhkd->bhqk", q32, k_cur.float()) * scale
        if causal:
            visible = (me * S + pos)[:, None] >= (k_idx * S + pos)[None, :]
            s = torch.where(visible, s, _NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1, keepdim=True))
        m_safe = torch.where(m_new <= masked, 0.0, m_new)
        p = torch.exp(torch.where(s <= masked, -math.inf, s - m_safe))
        alpha = torch.exp(torch.where(m_run <= masked, -math.inf,
                                      m_run - m_safe))
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p,
                                         v_cur.float())
        l_run = l_run * alpha + p.sum(dim=-1, keepdim=True)
        m_run = m_new
        if i < n - 1:
            k_cur = col.permute(k_cur, axis, perm)
            v_cur = col.permute(v_cur, axis, perm)
    out = acc / torch.where(l_run == 0.0, 1.0, l_run)
    return out.to(q.dtype)


def ulysses_attention(q, k, v, axis: str = "sp", *, causal: bool = False,
                      sm_scale: float | None = None):
    """DeepSpeed-Ulysses sequence parallelism.

    q, k, v: this rank's sequence chunk, (B, H, S/n, D). An all-to-all
    trades the sequence for the heads, (B, H/n, S, D), attention runs on
    the whole sequence of H/n heads (`flash_attention` on the card,
    `mha_reference` on the CPU), and a second all-to-all trades back.
    Runs inside mesh_context, or on DTensors (the collectives then use
    the current mesh, else theirs).
    """
    if isinstance(q, DTensor):
        with col.mesh_context(_collective_mesh(q)):
            return _on_local_shards(functools.partial(
                ulysses_attention, axis=axis, causal=causal,
                sm_scale=sm_scale), q, k, v, seq_axis=axis)
    n = col.axis_size(axis)
    if q.shape[1] % n:
        raise ValueError(f"ulysses needs heads ({q.shape[1]}) divisible by "
                         f"the axis ({n})")
    qh, kh, vh = (col.alltoall(t, axis, split_axis=1, concat_axis=2)
                  for t in (q, k, v))
    if q.device.type == "cpu":
        out = mha_reference(qh, kh, vh, sm_scale, causal)
    else:
        out = flash_attention(qh, kh, vh, sm_scale, causal)
    return col.alltoall(out.to(q.dtype), axis, split_axis=2, concat_axis=1)
