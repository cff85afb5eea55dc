"""The model families on the card: DiT with the flash kernels against DiT
with the plain attention, and the SSM's decode against its parallel
forward. Every test here needs a CUDA device and skips without one. The
file imports neither jax nor ray_tpu, so it runs where only the port is
installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_models.py

DiT's q, k and v reach the kernels as the model makes them: views of one
(B, S, 3H, D) projection, which the bf16 kernels load through TMA as they
are. Tolerances: f32 2e-5 forward and 1e-4 grads, as the JAX package's
flash tests; bf16 outputs elementwise |err| <= 2^-6 |ref| + max(rms(ref) /
32, 1e-5) (chip_smoke.bf16_err), the loss within 2^-8 and each gradient
within 2^-5 of its norm (chip_smoke.bf16_parity).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import dit as tdit  # noqa: E402
from ray_tpu_torch.models import ssm as tssm  # noqa: E402
from ray_tpu_torch.ops import attention as fa  # noqa: E402

pytestmark = pytest.mark.cuda

# tiny DiTs: head dim 16 (the FMA kernels in f32, wgmma padded to 64 in
# bf16), and DiT-XL/2's head dim 72 (padded to 128)
SHAPES = {"d16": dict(image_size=8, patch_size=2, d_model=32, n_heads=2),
          "d72": dict(image_size=16, patch_size=2, d_model=144, n_heads=2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _dit_run(cfg, params, batch, dev):
    """(output, loss, grads, flash launches) of one forward and one
    ddpm_loss backward of cfg."""
    model = tdit.DiT.from_params(cfg, {n: t.clone() for n, t in
                                       params.items()}, dev, trainable=True)
    images, labels, t = batch[:3]
    fa.reset_launch_counts()
    with torch.no_grad():
        out = model(images, t.float(), labels)
    loss = tdit._ddpm_loss(model, *batch)
    loss.backward()
    torch.cuda.synchronize()
    return (out, loss.detach(), {n: p.grad.float() for n, p in
                                 model.named_parameters()},
            dict(fa.launch_counts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_dit_flash_matches_reference_attention(cuda, shape, dtype):
    cfg = tdit.DiTConfig(**SHAPES[shape], n_layers=2, num_classes=4,
                         timesteps=50, dtype=dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = {n: (t.float() + 0.02 * torch.randn(
        t.shape, generator=g, device=cuda)).to(t.dtype)
        for n, t in convert.init_params(cfg, seed=0, device=cuda).items()}
    B, hw = 3, (cfg.image_size, cfg.image_size, cfg.channels)
    batch = (torch.randn(B, *hw, generator=g, device=cuda),
             torch.randint(0, 4, (B,), generator=g, device=cuda),
             torch.randint(0, 50, (B,), generator=g, device=cuda),
             torch.randn(B, *hw, generator=g, device=cuda),
             torch.rand(B, generator=g, device=cuda) < 0.3)
    want, want_loss, want_g, _ = _dit_run(
        dataclasses.replace(cfg, attention="reference"), params, batch, cuda)
    got, loss, grads, counts = _dit_run(cfg, params, batch, cuda)
    assert counts == {"flash_attention_forward": 4,
                      "flash_attention_backward": 2}
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        for name, gr in grads.items():
            torch.testing.assert_close(gr, want_g[name], rtol=1e-4,
                                       atol=1e-4, msg=name)
        return
    atol = max(want.square().mean().sqrt().item() / 32, 1e-5)
    torch.testing.assert_close(got, want, rtol=2 ** -6, atol=atol)
    assert abs(loss - want_loss) <= 2 ** -8 * abs(want_loss)
    for name, gr in grads.items():
        rel = (gr - want_g[name]).norm() / want_g[name].norm()
        assert rel <= 2 ** -5, (name, rel.item())


def test_dit_views_suit_the_kernels(cuda):
    """The q, k and v DiT hands over are views of one projection, which
    the bf16 kernels take without a copy at D 64 and D 72."""
    for shape in SHAPES.values():
        cfg = tdit.DiTConfig(**shape, dtype=torch.bfloat16)
        D, H, S = cfg.d_model, cfg.n_heads, cfg.num_patches
        qkv = torch.randn(2, S, 3 * D, device=cuda, dtype=torch.bfloat16)
        q, k, v = qkv.view(2, S, 3 * H, cfg.head_dim).transpose(1, 2) \
            .chunk(3, dim=1)
        assert not q.is_contiguous()
        assert [fa.tma_layout_problem(t) for t in (q, k, v)] == [None] * 3


def test_ssm_decode_matches_its_parallel_forward(cuda):
    """ssm_prefill, then ssm_decode_step token by token (eager, no graph),
    against the parallel forward over the whole sequence, in f32."""
    cfg = tssm.TINY_SSM
    model = tssm.SSMModel.from_params(
        cfg, convert.init_params(cfg, seed=0, device=cuda), cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=g,
                           device=cuda)
    with torch.no_grad():
        full = model(tokens)
        last, states = tssm.ssm_prefill(model, tokens[:, :24])
        torch.testing.assert_close(last, full[:, 23], rtol=2e-5, atol=2e-5)
        for t in range(24, 40):
            logits, states = tssm.ssm_decode_step(model, tokens[:, t],
                                                  states)
            torch.testing.assert_close(logits, full[:, t], rtol=2e-5,
                                       atol=2e-5)
