"""The flash attention CUDA kernels (forward, and the backward's dK/dV and
dQ kernels; bf16 with D <= 128 on wgmma and TMA) against their plain
PyTorch versions, on the card. Every test
here needs a CUDA device and skips without one. The file imports neither
jax nor ray_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_flash.py

Tolerances: f32 2e-5 forward and 1e-4 grads, as the JAX package's flash
tests (every product is an exact f32 FMA in both versions). bf16, forward
and grads, each tensor elementwise: |err| <= 2^-6 |ref| + max(rms(ref) / 32,
1e-5). Both versions round P, dS and the outputs to bf16 at the same
places, so they differ where the f32 sum order moves a value across a
rounding boundary: one ulp, 2^-8 to 2^-7 of the value, of the output or of
a P or dS term. rms / 32 is about four ulps at the tensor's typical size,
for values that cancel to near 0.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.ops import attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda

FWD_TOL, GRAD_TOL = 2e-5, 1e-4          # f32
DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, f32_tol):
    """f32: rtol = atol = f32_tol; bf16: the per-tensor rule above."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=f32_tol, atol=f32_tol)
        return
    want = want.float()
    atol = max(want.square().mean().sqrt().item() / 32, 1e-5)
    torch.testing.assert_close(got.float(), want, rtol=2 ** -6, atol=atol)


def _inputs(dev, dtype, B, H, Sq, Sk, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(B, H, s, D, generator=g, device=dev).to(dtype)
            for s in (Sq, Sk, Sk, Sq)]


def _as_model_view(t):
    """t as the model hands q, k and v over: a (B, S, H, D) tensor seen as
    (B, H, S, D)."""
    return t.transpose(1, 2).contiguous().transpose(1, 2)


def _check(dtype, Sq, Sk, D, causal, kv_valid_len=None, B=1, H=2,
           dev=None, v_transposed=False, qkv_views=False):
    q, k, v, do = _inputs(dev, dtype, B, H, Sq, Sk, D)
    if v_transposed or qkv_views:
        v = _as_model_view(v)
    if qkv_views:
        q, k = _as_model_view(q), _as_model_view(k)
    scale = 1 / math.sqrt(D)
    counts = dict(fa.launch_counts)
    out, lse = fa._flash_forward(q, k, v, scale, causal, 512, 512,
                                 kv_valid_len)
    want, want_lse = fa.flash_forward_reference(q, k, v, scale, causal, 512,
                                                512, kv_valid_len)
    res = (q, k, v, want, want_lse)
    grads = fa._flash_backward(scale, causal, 512, 512, kv_valid_len, res, do)
    want_grads = fa.flash_backward_reference(scale, causal, 512, 512,
                                             kv_valid_len, res, do)
    torch.cuda.synchronize()
    assert fa.launch_counts["flash_attention_forward"] == \
        counts["flash_attention_forward"] + 1
    assert fa.launch_counts["flash_attention_backward"] == \
        counts["flash_attention_backward"] + 1
    assert out.dtype == dtype and lse.dtype == torch.float32
    _assert_close(out, want, FWD_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=2e-5, atol=2e-5)
    for got, w in zip(grads, want_grads):
        assert got.dtype == dtype
        _assert_close(got, w, GRAD_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 72, 128])
@pytest.mark.parametrize("S", [1, 129, 333, 2048])
def test_kernels_match_plain(cuda, dtype, causal, D, S):
    _check(dtype, S, S, D, causal, dev=cuda)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ragged_shapes_and_key_mask(cuda, dtype):
    """Sq != Sk in both directions, kv_valid_len, a head dim that is not a
    power of two, one above 128, and v as a transposed view."""
    _check(dtype, 200, 333, 128, True, dev=cuda)
    _check(dtype, 333, 200, 72, True, dev=cuda)
    _check(dtype, 300, 333, 128, False, kv_valid_len=250, dev=cuda)
    _check(dtype, 130, 130, 256, True, dev=cuda, v_transposed=True)


def test_training_shape(cuda):
    """The training cell's attention: B 2, H 16, S 2048, D 128, causal."""
    _check(torch.bfloat16, 2048, 2048, 128, True, B=2, H=16, dev=cuda,
           v_transposed=True)


@pytest.mark.parametrize("shape", [
    pytest.param((2, 16, 2048, 2048, 128), id="training"),
    pytest.param((1, 3, 200, 333, 72), id="ragged"),
])
def test_qkv_views(cuda, shape):
    """q, k and v all as the model hands them over, (B, S, H, D) views,
    which the forward's TMA loads take with their own strides."""
    B, H, Sq, Sk, D = shape
    _check(torch.bfloat16, Sq, Sk, D, True, B=B, H=H, dev=cuda,
           qkv_views=True)


def _offset_by_one(t):
    """t's values in a view that starts one element into its storage."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    out = out.view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("layout", ["expanded", "offset"])
def test_backward_takes_autograd_gradient_layouts(cuda, layout):
    """dO as autograd may hand it over, an expanded (zero-stride) gradient
    or a view one element in: the autograd function copies what the
    backward's TMA loads cannot take, and the grads hold to the plain
    backward's with a contiguous dO. Called directly, the backward
    refuses such a dO instead."""
    q, k, v, do = _inputs(cuda, torch.bfloat16, 2, 4, 333, 333, 72)
    if layout == "expanded":
        do = do[:1, :1].expand(q.shape)
    else:
        do = _offset_by_one(do)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, None, True).backward(do)
    scale = 1 / math.sqrt(72)
    res = (q, k, v, *fa.flash_forward_reference(q, k, v, scale, True, 512,
                                                 512))
    want = fa.flash_backward_reference(scale, True, 512, 512, None, res,
                                       do.contiguous())
    for t, w in zip(leaves, want):
        _assert_close(t.grad, w, GRAD_TOL)
    with pytest.raises(ValueError, match="TMA"):
        fa._flash_backward(scale, True, 512, 512, None, res, do)


def test_backward_is_deterministic(cuda):
    """No atomics: two backward calls give bitwise equal grads."""
    q, k, v, do = _inputs(cuda, torch.bfloat16, 2, 16, 2048, 2048, 128)
    scale = 1 / math.sqrt(128)
    res = (q, k, v, *fa._flash_forward(q, k, v, scale, True, 512, 512))
    first = fa._flash_backward(scale, True, 512, 512, None, res, do)
    again = fa._flash_backward(scale, True, 512, 512, None, res, do)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_autograd_function_matches_plain_attention(cuda):
    q, k, v, do = _inputs(cuda, torch.float32, 2, 3, 100, 100, 32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.flash_attention(*leaves, None, True).backward(do)
    refs = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.mha_reference(*refs, causal=True).backward(do)
    for a, b in zip(leaves, refs):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("D", [pytest.param(64, id="f32"),
                               pytest.param(256, id="bf16-D256")])
def test_fma_forward_takes_a_negative_scale(cuda, D):
    """The FMA kernels scale each score before the row max, so they take
    any scale (the wgmma forward too: test_wgmma_forward_takes_any_scale)."""
    dtype = torch.float32 if D == 64 else torch.bfloat16
    q, k, v, _ = _inputs(cuda, dtype, 1, 2, 129, 129, D)
    out, lse = fa._flash_forward(q, k, v, -0.1, True, 64, 64)
    want, want_lse = fa.flash_forward_reference(q, k, v, -0.1, True, 64, 64)
    _assert_close(out, want, FWD_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=FWD_TOL, atol=FWD_TOL)


def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, _ = _inputs(cuda, torch.float32, 1, 2, 64, 64, 32)
    with pytest.raises(ValueError, match="dtype"):
        fa._flash_forward(q.double(), k.double(), v.double(), 0.1, True, 64,
                          64)
    with pytest.raises(ValueError, match="contiguous"):
        fa._flash_forward(q.transpose(2, 3).contiguous().transpose(2, 3), k,
                          v, 0.1, True, 64, 64)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa._flash_forward(q[..., :20], k[..., :20], v[..., :20], 0.1, True,
                          64, 64)
    with pytest.raises(ValueError, match="no key"):
        fa._flash_forward(q, k, v, 0.1, False, 64, 64, kv_valid_len=0)
    with pytest.raises(ValueError, match="is torch.bfloat16"):
        fa._flash_forward(q, k.bfloat16(), v, 0.1, True, 64, 64)
    # bf16 with D <= 128 loads through TMA: a base one element past a
    # 16-byte boundary is refused, never sent to another kernel.
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    shifted = torch.empty(qb.numel() + 1, dtype=torch.bfloat16,
                          device=cuda)[1:].view(qb.shape)
    shifted.copy_(qb)
    with pytest.raises(ValueError, match="TMA"):
        fa._flash_forward(shifted, kb, vb, 0.1, True, 64, 64)


@pytest.mark.parametrize("scale", [-0.1, 0.0])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
def test_wgmma_forward_takes_any_scale(cuda, scale, D, causal):
    """The wgmma forward (bf16, D <= 128) folds a scale <= 0 into Q, so
    its row max is still the extreme that becomes the max once scaled:
    out and lse match the plain version at a negative and a zero scale,
    with masked keys (the causal diagonal, a ragged last tile)."""
    q, k, v, _ = _inputs(cuda, torch.bfloat16, 1, 2, 129, 129, D)
    out, lse = fa._flash_forward(q, k, v, scale, causal, 64, 64)
    want, want_lse = fa.flash_forward_reference(q, k, v, scale, causal, 64,
                                                64)
    _assert_close(out, want, FWD_TOL)
    torch.testing.assert_close(lse, want_lse, rtol=FWD_TOL, atol=FWD_TOL)


def test_ulysses_world_of_one_is_flash_attention(cuda):
    """Ulysses over an sp axis of one rank (an NCCL world of one) gives
    flash_attention's out and q, k, v grads bit for bit, through one
    launch of each kernel."""
    import socket

    import torch.distributed as dist

    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.util.collective import ops as col

    q, k, v, do = _inputs(cuda, torch.bfloat16, 2, 16, 2048, 2048, 128)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        with col.mesh_context(make_mesh(MeshConfig())):
            grads = []
            for fn in (lambda *t: fa.flash_attention(*t, causal=True),
                       lambda *t: fa.ulysses_attention(*t, axis="sp",
                                                       causal=True)):
                qkv = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                fa.reset_launch_counts()
                out = fn(*qkv)
                out.backward(do)
                torch.cuda.synchronize()
                assert fa.launch_counts == {"flash_attention_forward": 1,
                                            "flash_attention_backward": 1}
                grads.append([out] + [t.grad for t in qkv])
    finally:
        dist.destroy_process_group()
    for want, got in zip(*grads):
        assert torch.equal(want, got)
