"""The port's flash attention against the JAX package's.

The JAX forward runs its Pallas kernel in interpret mode on the CPU, as
its own tests run it, and its backward is the custom_vjp's scan; the port
runs its plain PyTorch versions, which its CUDA kernels are held against
on the card (chip_smoke.py, tests/test_torch_cuda_flash.py). Inputs come
from a seeded numpy generator. Tolerances are those of
tests/test_ops_attention.py: 2e-5 for the f32 forward, 1e-4 for grads,
3e-2 for bf16.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from ray_tpu.ops import attention as ja  # noqa: E402
from ray_tpu_torch.ops import attention as ta  # noqa: E402


def _qkv(shape, seed, dtype=np.float32, sk=None):
    rng = np.random.default_rng(seed)
    B, H, S, D = shape
    k_shape = (B, H, sk or S, D)
    return [rng.standard_normal(s).astype(np.float32).astype(dtype)
            for s in (shape, k_shape, k_shape)]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("causal", [False, True])
def test_flash_forward_and_lse_match_jax(causal):
    q, k, v = _qkv((2, 2, 128, 32), seed=0)
    scale = 1 / math.sqrt(32)
    want, want_lse = ja._flash_forward(*map(jnp.asarray, (q, k, v)), scale,
                                       causal, 32, 64)
    got, got_lse = ta._flash_forward(*map(_torch, (q, k, v)), scale, causal,
                                     32, 64)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(_np(got_lse), np.asarray(want_lse), atol=2e-5,
                               rtol=2e-5)
    # The public function, and the plain attention it replaces.
    out = ta.flash_attention(*map(_torch, (q, k, v)), None, causal, 32, 64)
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=2e-5,
                               rtol=2e-5)
    ref = ta.mha_reference(*map(_torch, (q, k, v)), causal=causal)
    np.testing.assert_allclose(_np(ref), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


def test_flash_grads_match_jax():
    q, k, v = _qkv((1, 2, 128, 32), seed=1)
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: ja.flash_attention(q, k, v, None, True,
                                                        32, 32),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    ta.flash_attention(tq, tk, tv, None, True, 32, 32).backward(_torch(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_grads_match_jax_at_ragged_card_shapes(causal):
    """S 333 and D 72, shapes at which the card tests hold the kernels
    against the plain version: the plain version holds to JAX there."""
    q, k, v = _qkv((1, 2, 333, 72), seed=8)
    g = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: ja.flash_attention(q, k, v, None,
                                                        causal),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = (_torch(a).requires_grad_() for a in (q, k, v))
    ta.flash_attention(tq, tk, tv, None, causal).backward(_torch(g))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(_np(got), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)


def test_flash_bf16_matches_jax():
    q, k, v = _qkv((1, 2, 128, 32), seed=3, dtype=ml_dtypes.bfloat16)
    want = ja.flash_attention(*map(jnp.asarray, (q, k, v)), None, True, 32, 32)
    got = ta.flash_attention(*map(_torch, (q, k, v)), None, True, 32, 32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("shape,causal", [
    pytest.param((1, 2, 768, 32), True, id="768-causal"),
    pytest.param((1, 1, 129, 16), False, id="prime-129")])
def test_flash_non_block_multiple_seq_matches_jax(shape, causal):
    """The default 512 blocks shrink to a divisor of S (768: 256), and a
    prime S runs as one block."""
    (q,) = _qkv(shape, seed=4)[:1]
    want = ja.flash_attention(*[jnp.asarray(q)] * 3, None, causal)
    got = ta.flash_attention(*[_torch(q)] * 3, None, causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_kv_valid_len_matches_jax(causal):
    """A key-padding mask through both halves, with Sq != Sk."""
    q, k, v = _qkv((1, 2, 64, 16), seed=5, sk=96)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    scale, kv = 0.3, 70
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    out, lse = ja._flash_forward(jq, jk, jv, scale, causal, 32, 32, kv)
    want = ja._flash_backward(scale, causal, 32, 32, kv,
                              (jq, jk, jv, out, lse), jnp.asarray(g))
    tq, tk, tv = map(_torch, (q, k, v))
    tout, tlse = ta._flash_forward(tq, tk, tv, scale, causal, 32, 32, kv)
    got = ta._flash_backward(scale, causal, 32, 32, kv,
                             (tq, tk, tv, tout, tlse), _torch(g))
    np.testing.assert_allclose(_np(tout), np.asarray(out), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_allclose(_np(tlse), np.asarray(lse), atol=2e-5,
                               rtol=2e-5)
    for a, w in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(w), atol=1e-4,
                                   rtol=1e-4)
    assert not _np(got[1])[:, :, kv:].any()   # padding keys get no grad


def test_flash_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA device is refused, never
    sent to the plain version."""
    q, k, v = (_torch(a).to("meta") for a in _qkv((1, 1, 16, 16), seed=7))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ta._flash_forward(q, k, v, 0.25, True, 16, 16)
    assert ta.launch_counts["flash_attention_forward"] == 0


@pytest.mark.parametrize("layout,problem", [
    pytest.param("contiguous", None, id="contiguous"),
    pytest.param("model_view", None, id="model-view"),
    pytest.param("d72", None, id="d72"),
    pytest.param("offset", "16-byte boundary", id="offset-by-one"),
])
def test_tma_layout_rule(layout, problem):
    """The forward's TMA loads take a 16-byte aligned base and strides of
    multiples of 16 bytes: a contiguous (B, H, S, D) tensor, the model's
    (B, S, H, D) projection seen as (B, H, S, D), and D = 72 suit; a view
    one element into its storage does not."""
    B, H, S, D = 2, 3, 5, 72 if layout == "d72" else 64
    if layout == "model_view":
        t = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    elif layout == "offset":
        n = B * H * S * D
        t = torch.zeros(n + 1, dtype=torch.bfloat16)[1:].view(B, H, S, D)
    else:
        t = torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    got = ta.tma_layout_problem(t)
    if problem is None:
        assert got is None
    else:
        assert problem in got


@pytest.mark.parametrize("layout,copied,problem", [
    pytest.param("contiguous", False, None, id="contiguous"),
    pytest.param("model_view", False, None, id="model-view"),
    pytest.param("expanded", True, "stride is 0", id="expanded"),
    pytest.param("offset", True, "16-byte boundary", id="offset-by-one"),
    pytest.param("last_dim_strided", True, None, id="last-dim-strided"),
])
def test_backward_grad_layout_rule(layout, copied, problem):
    """The output's gradient in the layouts autograd may hand over: those
    the backward's TMA loads take pass as they are; the others are copied
    by the autograd function (`grad_for_kernels`), and a direct call of
    the backward refuses them (`tma_layout_problem` names why)."""
    B, H, S, D = 2, 3, 5, 64
    if layout == "model_view":
        do = torch.zeros(B, S, H, D, dtype=torch.bfloat16).transpose(1, 2)
    elif layout == "expanded":
        do = torch.ones(1, 1, 1, 1, dtype=torch.bfloat16).expand(B, H, S, D)
    elif layout == "offset":
        do = torch.zeros(B * H * S * D + 1, dtype=torch.bfloat16)[1:].view(
            B, H, S, D)
    elif layout == "last_dim_strided":
        do = torch.zeros(B, H, S, 2 * D, dtype=torch.bfloat16)[..., ::2]
    else:
        do = torch.zeros(B, H, S, D, dtype=torch.bfloat16)
    got = ta.grad_for_kernels(do)
    if copied:
        assert got is not do and got.is_contiguous()
        assert ta.tma_layout_problem(got) is None
        torch.testing.assert_close(got, do, rtol=0, atol=0)
    else:
        assert got is do
    if problem is None:
        assert layout == "last_dim_strided" or \
            ta.tma_layout_problem(do) is None
    else:
        assert problem in ta.tma_layout_problem(do)


def test_sequence_parallel_attention_raises():
    """Ring and Ulysses attention run over a mesh axis: outside
    mesh_context (on plain tensors) they raise."""
    q = torch.zeros(1, 1, 4, 16)
    for fn in (ta.ring_attention, ta.ulysses_attention):
        with pytest.raises(RuntimeError, match="mesh_context"):
            fn(q, q, q, causal=True)
